"""Generated protobuf wire format.

Regenerate with: protoc --python_out=. ballista.proto  (see build.sh)
"""
from ballista_tpu_torch.proto import ballista_pb2 as pb

__all__ = ["pb"]
