"""Object store glue (reference: core/src/object_store.rs — S3/MinIO glue).

Resolves table locations to pyarrow filesystems:
- local paths → LocalFileSystem
- s3://bucket/key → pyarrow.fs.S3FileSystem, configured from the standard
  AWS env vars (AWS_ACCESS_KEY_ID / AWS_SECRET_ACCESS_KEY / AWS_ENDPOINT_URL
  / AWS_REGION / AWS_ALLOW_HTTP — the same knobs the reference's S3Options
  reads). Build environments without network reach fail at FIRST READ with
  a clear error, not at registration.
"""

from __future__ import annotations

import os

import pyarrow.fs as pafs

from ballista_tpu_torch.errors import ConfigurationError


def resolve_filesystem(path: str):
    """Returns (filesystem, path_within_fs)."""
    if path.startswith("s3://"):
        kwargs = {}
        if os.environ.get("AWS_REGION"):
            kwargs["region"] = os.environ["AWS_REGION"]
        if os.environ.get("AWS_ENDPOINT_URL"):
            kwargs["endpoint_override"] = os.environ["AWS_ENDPOINT_URL"]
        if os.environ.get("AWS_ACCESS_KEY_ID"):
            kwargs["access_key"] = os.environ["AWS_ACCESS_KEY_ID"]
            kwargs["secret_key"] = os.environ.get("AWS_SECRET_ACCESS_KEY", "")
        if os.environ.get("AWS_ALLOW_HTTP", "").lower() in ("1", "true"):
            kwargs["scheme"] = "http"
        try:
            fs = pafs.S3FileSystem(**kwargs)
        except Exception as e:  # noqa: BLE001
            raise ConfigurationError(f"cannot initialize S3 filesystem: {e}") from None
        return fs, path[len("s3://"):]
    if path.startswith("file://"):
        return pafs.LocalFileSystem(), path[len("file://"):]
    return pafs.LocalFileSystem(), path
