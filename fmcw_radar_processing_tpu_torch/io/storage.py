"""Storage backends: the ingest/egress layer (SURVEY §1 L0/L1/L4).

The reference downloads radar_data.{xml,raw.bin} from Azure Blob Storage
via ``websave`` (read_data_from_blob_storage.m:26) and uploads JSON/PNG
artifacts via HTTP PUT with a SAS token
(send_json_string_to_blob_storage.m:4-37, send_picture_to_blob_storage.m).
Credentials were hard-coded there (SURVEY Appendix A #6); here they are
constructor/env-driven.

Backends implement a two-method protocol (get/put) so the serving handler
is storage-agnostic; ``LocalStorage`` doubles as the test double and the
on-prem deployment path.

The port's own copy of the JAX package's ``io/storage.py``.
"""

from __future__ import annotations

import os
import shutil
import urllib.error
import urllib.request
from typing import Protocol


class Storage(Protocol):
    def get(self, name: str, dest_path: str) -> None:
        """Download blob ``name`` to a local file."""
        ...

    def put(self, src_path: str, name: str, content_type: str) -> None:
        """Upload a local file as blob ``name``."""
        ...


class LocalStorage:
    """Directory-backed storage (local dev / tests / on-prem)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def get(self, name: str, dest_path: str) -> None:
        src = os.path.join(self.root, name)
        if not os.path.exists(src):
            raise FileNotFoundError(f"blob not found: {name}")
        if os.path.abspath(src) != os.path.abspath(dest_path):
            shutil.copyfile(src, dest_path)

    def put(self, src_path: str, name: str, content_type: str = "") -> None:
        dest = os.path.join(self.root, name)
        os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
        if os.path.abspath(src_path) != os.path.abspath(dest):
            shutil.copyfile(src_path, dest)


class AzureBlobStorage:
    """Azure Blob Storage over plain HTTPS (no SDK dependency).

    GET  {base}/{name}?{sas}                      (read_data_from_blob_storage.m:22,26)
    PUT  {base}/{name}?{sas}  x-ms-blob-type: BlockBlob
                              Content-Type: <type>  (send_json_string_to_blob_storage.m:18-27)
    """

    def __init__(
        self,
        account: str | None = None,
        container: str | None = None,
        sas_token: str | None = None,
        timeout: float = 60.0,  # webwrite timeout, send_json_string_to_blob_storage.m:17
        endpoint: str | None = None,  # custom endpoint (Azurite emulator /
        # sovereign clouds / the test stub); None = public Azure
    ):
        self.account = account or os.environ.get("FMCW_AZURE_ACCOUNT", "")
        self.container = container or os.environ.get("FMCW_AZURE_CONTAINER", "")
        self.sas_token = sas_token or os.environ.get("FMCW_AZURE_SAS", "")
        self.timeout = timeout
        self.endpoint = (endpoint or os.environ.get("FMCW_AZURE_ENDPOINT")
                         or f"https://{self.account}.blob.core.windows.net")
        if not self.account or not self.container:
            raise ValueError(
                "AzureBlobStorage needs account+container (args or "
                "FMCW_AZURE_ACCOUNT/FMCW_AZURE_CONTAINER env)"
            )

    def _url(self, name: str) -> str:
        base = f"{self.endpoint.rstrip('/')}/{self.container}"
        sas = f"?{self.sas_token}" if self.sas_token else ""
        return f"{base}/{name}{sas}"

    def get(self, name: str, dest_path: str) -> None:
        with urllib.request.urlopen(self._url(name), timeout=self.timeout) as r:
            with open(dest_path, "wb") as f:
                shutil.copyfileobj(r, f)

    def put(self, src_path: str, name: str, content_type: str) -> None:
        with open(src_path, "rb") as f:
            data = f.read()
        req = urllib.request.Request(
            self._url(name),
            data=data,
            method="PUT",
            headers={
                "x-ms-blob-type": "BlockBlob",
                "Content-Type": content_type,
                "Content-Length": str(len(data)),
            },
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                if r.status not in (200, 201):  # Azure returns 201 Created
                    raise RuntimeError(f"upload of {name} failed: HTTP {r.status}")
        except urllib.error.HTTPError as e:
            # Mirror the reference's error-stream decode
            # (send_picture_to_blob_storage.m:61-74).
            body = e.read().decode("utf-8", "replace")[:500]
            raise RuntimeError(f"upload of {name} failed: HTTP {e.code}: {body}")


def get_storage(spec: str | None = None) -> Storage:
    """Resolve a storage backend from a spec string / environment.

    spec: 'local:<dir>' | 'azure' | None (env FMCW_STORAGE, default
    'local:./blobs').
    """
    spec = spec or os.environ.get("FMCW_STORAGE", "local:./blobs")
    if spec.startswith("local:"):
        return LocalStorage(spec[len("local:"):])
    if spec == "azure":
        return AzureBlobStorage()
    raise ValueError(f"unknown storage spec: {spec}")
