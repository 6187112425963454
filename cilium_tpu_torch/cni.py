"""CNI plugin: container runtime -> agent endpoint lifecycle.

Reference: plugins/cilium-cni/cilium-cni.go — kubelet invokes the
plugin with CNI_COMMAND=ADD/DEL and a JSON config on stdin; the plugin
allocates addressing and drives the agent's REST endpoint API, then
prints a CNI result object. Exposed as ``cilium-tpu cni`` so the same
binary serves both roles (like the reference's single distribution).

A whole copy of ``cilium_tpu/cni.py`` over the port's ``cli.Client``.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, Optional

from .cli import Client
from .endpoint.ids import CNI_ID_BASE, stable_endpoint_id

CNI_VERSION = "0.3.1"


def _endpoint_id_for(container_id: str) -> int:
    """Stable endpoint id derived from the container id (the reference
    derives it from the interface; any stable mapping works)."""
    return stable_endpoint_id(container_id, CNI_ID_BASE)


def cni_add(client: Client, container_id: str, netns: str = "",
            ifname: str = "eth0",
            config: Optional[Dict] = None) -> Dict:
    """CNI ADD: create the endpoint, return the CNI result."""
    config = config or {}
    ep_id = _endpoint_id_for(container_id)
    labels = [f"container:id={container_id}"]
    for k, v in (config.get("labels") or {}).items():
        labels.append(f"k8s:{k}={v}")
    ipv4 = config.get("ip", "")
    try:
        ep = client.put(f"/endpoint/{ep_id}", {
            "ipv4": ipv4, "container-name": container_id[:12],
            "labels": labels})
    except SystemExit as e:
        # runtimes retry ADD; an existing endpoint is success
        # (idempotency per the CNI spec) — return its addressing
        if getattr(e, "status", None) != 409:
            raise
        ep = client.get(f"/endpoint/{ep_id}")
    result = {
        "cniVersion": CNI_VERSION,
        "interfaces": [{"name": ifname, "sandbox": netns}],
        "ips": [{"version": "4",
                 "address": f"{ep['addressing']['ipv4']}/32"}]
        if ep["addressing"]["ipv4"] else [],
    }
    return result


def cni_del(client: Client, container_id: str) -> bool:
    ep_id = _endpoint_id_for(container_id)
    try:
        client.delete(f"/endpoint/{ep_id}")
        return True
    except SystemExit as e:
        # 404 = already gone: CNI DEL must be idempotent.  Any other
        # failure (unreachable agent, 5xx) must propagate — reporting
        # success would stop the runtime's retries and leak the
        # endpoint, its IP, and its identity refcount in the agent
        if getattr(e, "status", None) == 404:
            return False
        raise


def main(argv=None) -> int:
    """Entry for CNI invocation (env-var driven, per the CNI spec)."""
    command = os.environ.get("CNI_COMMAND", "")
    container_id = os.environ.get("CNI_CONTAINERID", "")
    netns = os.environ.get("CNI_NETNS", "")
    ifname = os.environ.get("CNI_IFNAME", "eth0")
    api = os.environ.get("CILIUM_TPU_API", "http://127.0.0.1:9234")
    client = Client(api)
    try:
        config = json.load(sys.stdin) if not sys.stdin.isatty() else {}
    except ValueError:
        config = {}
    if command == "ADD":
        print(json.dumps(cni_add(client, container_id, netns, ifname,
                                 config)))
        return 0
    if command == "DEL":
        try:
            cni_del(client, container_id)
        except SystemExit as e:
            # CNI error result (spec 1.0 "error" object, code 7 =
            # generic failure): non-zero exit makes the runtime retry
            print(json.dumps({"code": 7, "msg": str(e)}))
            return 1
        return 0
    if command == "VERSION":
        print(json.dumps({"cniVersion": CNI_VERSION,
                          "supportedVersions": [CNI_VERSION]}))
        return 0
    print(json.dumps({"code": 4,
                      "msg": f"unsupported CNI_COMMAND {command!r}"}))
    return 1


if __name__ == "__main__":
    sys.exit(main())
