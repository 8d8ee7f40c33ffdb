from ballista_tpu_torch.scheduler.process import main

main()
