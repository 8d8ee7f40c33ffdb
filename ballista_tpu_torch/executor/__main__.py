from ballista_tpu_torch.executor.executor_process import main

main()
