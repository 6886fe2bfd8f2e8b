"""Object-store abstraction: the S3 surface behind the cloud pipeline.

The reference's stages communicate through S3 objects: the masks Batch
job downloads radiance and uploads the mask
(msf_flow/deployment/spectrometer-masks/masks_sds.py:261-330), msf_flow
round-trips plume lists (msf_flow/workflow/msf_flow.py:286-348,:176-267),
windMNSTD prefetches GRIBs (windspeed.py:226-252), and every
lambda_handler consumes an S3 event. This environment has no AWS and no
egress, so the same surface is an interface with two backends:

- :class:`LocalObjectStore` — a directory tree keyed like a bucket (the
  zero-egress stand-in; also what the tests exercise);
- :class:`S3ObjectStore` — boto3-backed, import-gated, same interface.

``open_store("s3://bucket/prefix")`` / ``open_store("file:///dir")`` /
``open_store("/dir")`` pick the backend from the URI, so CLIs accept
either transparently. The port's copy of the JAX package's
``flow/objectstore.py``.
"""

from __future__ import annotations

import glob
import os
import shutil

__all__ = ["ObjectStore", "LocalObjectStore", "S3ObjectStore",
           "open_store", "split_uri"]


class ObjectStore:
    """get/put/list/exists over opaque keys."""

    def get(self, key: str, dest: str) -> str:
        raise NotImplementedError

    def put(self, src: str, key: str) -> str:
        raise NotImplementedError

    def list(self, prefix: str = ""):
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError


class LocalObjectStore(ObjectStore):
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        p = os.path.normpath(os.path.join(self.root, key))
        if not os.path.abspath(p).startswith(os.path.abspath(self.root)):
            raise ValueError(f"key escapes store root: {key!r}")
        return p

    def get(self, key, dest):
        os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
        shutil.copyfile(self._path(key), dest)
        return dest

    def put(self, src, key):
        p = self._path(key)
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
        shutil.copyfile(src, p)
        return key

    def list(self, prefix=""):
        pat = os.path.join(self.root, prefix + "*")
        hits = []
        for p in sorted(glob.glob(pat) + glob.glob(
                os.path.join(self.root, prefix + "**", "*"),
                recursive=True)):
            if os.path.isfile(p):
                hits.append(os.path.relpath(p, self.root))
        return sorted(set(hits))

    def exists(self, key):
        return os.path.isfile(self._path(key))


class S3ObjectStore(ObjectStore):
    """boto3-backed store (reference: the AWS=TRUE code paths,
    msf_flow.py:23, windspeed.py:18). Import-gated — raises a clear
    error when boto3 is absent (this environment)."""

    def __init__(self, bucket: str, prefix: str = ""):
        try:
            import boto3
        except ImportError as e:
            raise ImportError(
                "S3ObjectStore needs boto3 (not available in this "
                "environment); use a file:// store instead") from e
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        self._s3 = boto3.client("s3")

    def _key(self, key):
        return f"{self.prefix}/{key}".strip("/") if self.prefix else key

    def get(self, key, dest):
        os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
        self._s3.download_file(self.bucket, self._key(key), dest)
        return dest

    def put(self, src, key):
        self._s3.upload_file(src, self.bucket, self._key(key))
        return key

    def list(self, prefix=""):
        out = []
        paginator = self._s3.get_paginator("list_objects_v2")
        for page in paginator.paginate(Bucket=self.bucket,
                                       Prefix=self._key(prefix)):
            for obj in page.get("Contents", []):
                k = obj["Key"]
                if self.prefix:
                    k = k[len(self.prefix) + 1:]
                out.append(k)
        return out

    def exists(self, key):
        try:
            self._s3.head_object(Bucket=self.bucket, Key=self._key(key))
            return True
        except Exception:
            return False


def split_uri(uri: str):
    """'s3://bucket/k/ey' -> ('s3', 'bucket', 'k/ey');
    'file:///d/ir' or '/d/ir' -> ('file', '', '/d/ir')."""
    if uri.startswith("s3://"):
        rest = uri[5:]
        bucket, _, key = rest.partition("/")
        return "s3", bucket, key
    if uri.startswith("file://"):
        return "file", "", uri[7:]
    return "file", "", uri


def open_store(uri: str):
    """URI -> (store, key). Local URIs always name a store ROOT
    directory (created if absent), key ""; s3 URIs split into
    (bucket+prefix, trailing key)."""
    scheme, bucket, path = split_uri(uri)
    if scheme == "s3":
        prefix, _, key = path.rpartition("/")
        return S3ObjectStore(bucket, prefix), key
    return LocalObjectStore(path), ""
