"""Compute Engine ``instances`` REST client (``compute.googleapis.com`` v1),
for GPU hosts.

The HTTP layer of :class:`ray_tpu_torch.autoscaler.GPUVMNodeProvider`, the
port's counterpart of ``ray_tpu/tpu_vm_api.py`` (reference: the GCP node
provider, ``autoscaler/_private/gcp/node_provider.py``, which speaks the
Compute API through googleapiclient; this speaks REST directly with urllib
— no SDK in the image). A TPU slice is one API object; a GPU node is a
group of instances (``a3-highgpu-8g``: 8 H100 cards a host), which the
provider creates one by one as a gang.

Every call goes through ``self._transport(verb, url, body, headers)``,
which defaults to urllib; tests inject a fake transport or construct with
``dry_run=True`` to record requests. Auth is a pluggable ``token_fn``
defaulting to the GCE metadata server (how a head inside GCP authenticates
without key files).
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Callable, Dict, List, Optional

API_ROOT = "https://compute.googleapis.com/compute/v1"
METADATA_TOKEN_URL = ("http://metadata.google.internal/computeMetadata/v1/"
                      "instance/service-accounts/default/token")
DEFAULT_MACHINE_TYPE = "a3-highgpu-8g"  # 8 x H100 80GB a host
DEFAULT_IMAGE = ("projects/deeplearning-platform-release/global/images/"
                 "family/common-cu124-ubuntu-2204")


class GpuApiError(RuntimeError):
    def __init__(self, status: int, message: str):
        self.status = status
        super().__init__(f"Compute API error {status}: {message}")


def metadata_token() -> str:
    """OAuth token from the GCE metadata server (valid on any GCP VM)."""
    req = urllib.request.Request(METADATA_TOKEN_URL,
                                 headers={"Metadata-Flavor": "Google"})
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read())["access_token"]


def _urllib_transport(verb: str, url: str, body: Optional[dict],
                      headers: Dict[str, str]) -> dict:
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=verb,
                                 headers={"Content-Type": "application/json",
                                          **headers})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            payload = resp.read()
            return json.loads(payload) if payload else {}
    except urllib.error.HTTPError as e:
        raise GpuApiError(e.code, e.read().decode(errors="replace")) from e


class GpuVmClient:
    """Typed wrapper over the zonal ``instances`` and ``operations``
    endpoints the provisioning path needs: insert (returns an operation),
    get, delete, list by label, operation polling, and each host's
    address."""

    def __init__(
        self,
        project: str,
        zone: str,
        token_fn: Callable[[], str] = metadata_token,
        transport: Optional[Callable] = None,
        dry_run: bool = False,
        api_root: str = API_ROOT,
    ):
        self.zone = zone
        self.parent = f"projects/{project}/zones/{zone}"
        self._root = api_root.rstrip("/")
        self._token_fn = token_fn
        self.dry_run = dry_run
        self.requests: List[Dict[str, Any]] = []  # dry-run/test record
        self._transport = transport or _urllib_transport

    # ------------------------------------------------------------ plumbing

    def _call(self, verb: str, path: str,
              body: Optional[dict] = None) -> dict:
        url = f"{self._root}/{path}"
        self.requests.append({"verb": verb, "path": path, "body": body})
        if self.dry_run:
            return {"name": "dry-run", "status": "DONE"}
        headers = {"Authorization": f"Bearer {self._token_fn()}"}
        return self._transport(verb, url, body, headers)

    # ----------------------------------------------------------- instances

    def create_instance(
        self,
        name: str,
        machine_type: str = DEFAULT_MACHINE_TYPE,
        labels: Optional[Dict[str, str]] = None,
        metadata: Optional[Dict[str, str]] = None,
    ) -> dict:
        """POST instances — one host with its cards (an A3 machine type
        carries them; GPU hosts stop on maintenance). Returns the zonal
        operation."""
        meta = dict(metadata or {})
        body = {
            "name": name,
            "machineType": f"zones/{self.zone}/machineTypes/{machine_type}",
            "labels": labels or {},
            "metadata": {"items": [{"key": k, "value": v}
                                   for k, v in meta.items()]},
            "disks": [{"boot": True, "autoDelete": True,
                       "initializeParams": {"sourceImage": DEFAULT_IMAGE,
                                            "diskSizeGb": "200"}}],
            "networkInterfaces": [{"network": "global/networks/default"}],
            "scheduling": {"onHostMaintenance": "TERMINATE"},
        }
        return self._call("POST", f"{self.parent}/instances", body)

    def delete_instance(self, name: str) -> dict:
        return self._call("DELETE", f"{self.parent}/instances/{name}")

    def get_instance(self, name: str) -> dict:
        return self._call("GET", f"{self.parent}/instances/{name}")

    def list_instances(self, labels: Optional[Dict[str, str]] = None
                       ) -> List[dict]:
        """Every instance of the zone carrying all of ``labels``."""
        query = ""
        if labels:
            filt = " AND ".join(f"labels.{k}={v}"
                                for k, v in sorted(labels.items()))
            query = "?filter=" + urllib.parse.quote(filt)
        items: List[dict] = []
        page = self._call("GET", f"{self.parent}/instances{query}")
        items.extend(page.get("items", []))
        while page.get("nextPageToken"):
            sep = "&" if query else "?"
            page = self._call(
                "GET", f"{self.parent}/instances{query}{sep}pageToken="
                       f"{page['nextPageToken']}")
            items.extend(page.get("items", []))
        return items

    # --------------------------------------------------------- operations

    def wait_operation(self, op: dict, timeout: float = 900.0,
                       poll_s: float = 5.0) -> dict:
        """Poll a zonal operation until it is DONE (an instance insert
        takes a minute or more)."""
        deadline = time.monotonic() + timeout
        while op.get("status") != "DONE":
            if time.monotonic() > deadline:
                raise TimeoutError(f"operation {op.get('name')} timed out")
            time.sleep(poll_s)
            op = self._call("GET", f"{self.parent}/operations/{op['name']}")
        if op.get("error"):
            errs = op["error"].get("errors") or [{}]
            raise GpuApiError(op.get("httpErrorStatusCode", -1),
                              errs[0].get("message", str(op["error"])))
        return op

    # ----------------------------------------------------------- helpers

    @staticmethod
    def instance_host(instance: dict) -> str:
        """The instance's internal address (first network interface)."""
        nics = instance.get("networkInterfaces") or [{}]
        return nics[0].get("networkIP", "")
