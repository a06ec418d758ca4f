"""Artifact store: local-path / s3:// / gs:// cached reads.

Own copy of coati_tpu/common/artifacts.py. Everything local works without
extra packages; s3:// needs boto3 and gs:// gcsfs, and without them those
URIs raise ImportError before anything is fetched.

Cache dir resolution: $COATI_TPU_CACHE_DIR, then $S3_CACHE_DIR (the
reference's name), then ~/.cache/coati_tpu.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

from coati_tpu_torch.common.util import makedir

try:  # optional dependency
    import boto3
    from botocore import UNSIGNED
    from botocore.config import Config as _BotoConfig

    HAS_BOTO3 = True
except ImportError:
    HAS_BOTO3 = False

DEFAULT_BUCKET = "terray-public"


def cache_dir() -> str:
    return (
        os.environ.get("COATI_TPU_CACHE_DIR")
        or os.environ.get("S3_CACHE_DIR")
        or os.path.join(os.path.expanduser("~"), ".cache", "coati_tpu")
    )


def _require_boto3() -> None:
    if not HAS_BOTO3:
        raise ImportError(
            "boto3 is required for s3:// URIs but is not installed. "
            "Pass a local path instead, or install boto3."
        )


def _s3_client():
    _require_boto3()
    return boto3.client("s3", config=_BotoConfig(signature_version=UNSIGNED))


def _parse_s3_uri(uri: str):
    rest = uri[len("s3://") :]
    bucket, _, key = rest.partition("/")
    return bucket, key


def local_cache_path(uri: str) -> str:
    bucket, key = _parse_s3_uri(uri)
    return os.path.join(cache_dir(), bucket, key)


def sync_s3_to_local(bucket: str, key: str) -> str:
    """Download one object into the cache if absent/stale; return local path."""
    _require_boto3()
    dest = os.path.join(cache_dir(), bucket, key)
    client = _s3_client()
    head = client.head_object(Bucket=bucket, Key=key)
    remote_mtime = head["LastModified"].timestamp()
    if os.path.exists(dest) and os.path.getmtime(dest) >= remote_mtime:
        return dest
    makedir(dest, isfile=True)
    client.download_file(bucket, key, dest)
    return dest


def download_from_s3(uri: str) -> str:
    """s3://bucket/key -> cached local path."""
    bucket, key = _parse_s3_uri(uri)
    return sync_s3_to_local(bucket, key)


def copy_bucket_dir_from_s3(s3_path: str, local_dir: str, bucket: str = DEFAULT_BUCKET):
    """Recursively mirror an s3 prefix into local_dir/s3_path."""
    _require_boto3()
    client = _s3_client()
    paginator = client.get_paginator("list_objects_v2")
    for page in paginator.paginate(Bucket=bucket, Prefix=s3_path):
        for obj in page.get("Contents", []):
            key = obj["Key"]
            dest = os.path.join(local_dir, key)
            if os.path.exists(dest) and os.path.getsize(dest) == obj["Size"]:
                continue
            makedir(dest, isfile=True)
            client.download_file(bucket, key, dest)
    return os.path.join(local_dir, s3_path)


def _download_from_gs(uri: str) -> str:
    """Cache a gs:// object locally via gcsfs (optional dependency)."""
    try:
        import gcsfs
    except ImportError as ex:
        raise ImportError(
            "gcsfs is required for gs:// URIs but is not installed. "
            "Pass a local path or s3:// URI instead, or install gcsfs."
        ) from ex
    rel = uri[len("gs://") :]
    dest = os.path.join(cache_dir(), "gs", rel)
    if not os.path.exists(dest):
        makedir(dest, isfile=True)
        gcsfs.GCSFileSystem(token="anon").get(rel, dest)
    return dest


@contextmanager
def cache_read(uri_or_path: str, mode: str = "rb"):
    """Open a local path, file:// URI, or (cached) s3:// / gs:// URI
    for reading."""
    if uri_or_path.startswith("s3://"):
        path = download_from_s3(uri_or_path)
    elif uri_or_path.startswith("gs://"):
        path = _download_from_gs(uri_or_path)
    elif uri_or_path.startswith("file://"):
        path = uri_or_path[len("file://") :]
    else:
        path = uri_or_path
    with open(path, mode) as f:
        yield f
