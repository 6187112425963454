"""k8s event watcher driving the daemon.

Reference: daemon/k8s_watcher.go — informers for CNPs, k8s
NetworkPolicies, Services, Endpoints, Pods, Nodes, Namespaces and
Ingresses feed the policy repository, the service/endpoint state, the
ipcache, and node tunneling; the agent reports per-node CNP status
back (k8s_watcher.go:1748 cnpNodeStatusController).  Here the watcher
is a sink for an event stream (dicts shaped like k8s watch events);
any source — a test, a file replay, or a real apiserver client —
pushes into it.

Port of ``cilium_tpu/k8s/watcher.py`` over the port's ``Daemon``.  One
difference: the CNP status worker stops with ``stop()`` (the reference
leaves its thread to the interpreter), so a stopped watcher leaves no
thread behind.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional

from ..identity import RESERVED_UNMANAGED
from ..labels import LabelArray, Label, SOURCE_K8S
from ..node import Node, NodeAddress
from ..utils.serializer import FunctionQueue
from .policy import (NS_LABELS_BASE, POLICY_LABEL_NAME,
                     POLICY_LABEL_NAMESPACE, parse_cnp,
                     parse_network_policy)
from .translate import endpoints_to_ips, translate_to_services

# namespace meta labels carried onto pods in that namespace
# (reference: ciliumio.PodNamespaceMetaLabels prefix) — one constant
# shared with the selector side (k8s/policy.py) so namespaceSelector
# matching can't silently drift
NS_META_PREFIX = NS_LABELS_BASE


def _policy_key_labels(name: str, namespace: str) -> LabelArray:
    return LabelArray([
        Label(key=POLICY_LABEL_NAME, value=name, source=SOURCE_K8S),
        Label(key=POLICY_LABEL_NAMESPACE, value=namespace,
              source=SOURCE_K8S)])


class K8sWatcher:
    """Apply k8s object events to a Daemon."""

    def __init__(self, daemon, ingress_host_ip: str = "192.168.254.1"):
        self.daemon = daemon
        self._lock = threading.Lock()
        # (namespace, service) -> backend ips, for ToServices
        self._endpoints: Dict[tuple, List[str]] = {}
        # (namespace, service) -> {"headless": bool, "ports": [...]}
        self._services: Dict[tuple, Dict] = {}
        # (namespace, cnp name) -> {node: status dict} — the per-node
        # CNP status the reference writes back to the apiserver
        # (k8s_watcher.go:1834 updateCNPNodeStatus)
        self.cnp_status: Dict[tuple, Dict[str, Dict]] = {}
        # namespace -> its labels (for pod namespace meta labels)
        self._ns_labels: Dict[str, Dict[str, str]] = {}
        # the address ingress frontends resolve to on this node
        # (reference: option.Config.HostV4Addr)
        self.ingress_host_ip = ingress_host_ip
        # (namespace, ingress name) -> (service name, servicePort)
        self._ingresses: Dict[tuple, tuple] = {}
        # (namespace, ingress name) -> last programmed frontend port
        self._ingress_ports: Dict[tuple, int] = {}
        # (namespace, pod name) -> last known podIP (for IP-change
        # cleanup on modified events)
        self._pod_ips: Dict[tuple, str] = {}
        self.events_processed = 0
        self.events_by_kind: Dict[str, int] = {}
        # async dispatch state: one ordered FunctionQueue per resource
        # kind + last applied resourceVersion per object (staleness
        # dedup, pkg/versioned analog)
        self._queues: Dict[str, FunctionQueue] = {}
        self._resource_versions: Dict[tuple, str] = {}
        self._apply_lock = threading.RLock()
        self._stopped = False
        # the CNP status worker (started on the first CNP) and its stop
        self._status_q: Optional["queue.Queue"] = None
        self._status_thread: Optional[threading.Thread] = None
        self._status_stop = threading.Event()

    # ------------------------------------------------------------ policy

    def on_cnp(self, action: str, obj: Dict) -> None:
        """action: added | modified | deleted
        (k8s_watcher.go addCiliumNetworkPolicyV2 et al.).  Records the
        per-node enforcement status the reference writes back into the
        CNP's Status.Nodes map (cnpNodeStatusController): ok/enforcing
        with the realized revision on success, the import error
        otherwise."""
        meta = obj.get("metadata") or {}
        name = meta.get("name", "")
        namespace = meta.get("namespace", "default")
        skey = (namespace, name)
        key = _policy_key_labels(name, namespace)
        node = self.daemon.node_name
        if action in ("added", "modified"):
            try:
                rules = parse_cnp(obj)
                self._retranslate(rules)
                rev = self.daemon.policy_add(rules, replace=True)
            except Exception as e:  # noqa: BLE001 — report, don't die
                self.cnp_status.setdefault(skey, {})[node] = {
                    "ok": False, "enforcing": False, "error": repr(e),
                    "lastUpdated": time.time()}
                self._count("cnp")
                return
            # enforcing = every endpoint realized the revision; the
            # reference waits via a controller — one shared status
            # worker drains a queue (per-event threads would pile up
            # under CNP churn, all polling the endpoint list)
            self.cnp_status.setdefault(skey, {})[node] = {
                "ok": True, "enforcing": False, "revision": rev,
                "lastUpdated": time.time()}
            self._status_queue_put(skey, node, rev)
        elif action == "deleted":
            self.daemon.policy_delete(key)
            self.cnp_status.pop(skey, None)
        self._count("cnp")

    def get_cnp_status(self, namespace: str, name: str
                       ) -> Dict[str, Dict]:
        """The CNP's per-node status map (Status.Nodes analog)."""
        return dict(self.cnp_status.get((namespace, name), {}))

    def _status_queue_put(self, skey: tuple, node: str,
                          rev: int) -> None:
        with self._lock:
            if self._status_stop.is_set():
                return  # stopped: nothing drains the queue any more
            if self._status_q is None:
                self._status_q = queue.Queue()
                self._status_thread = threading.Thread(
                    target=self._status_worker, daemon=True,
                    name="cnp-status")
                self._status_thread.start()
            self._status_q.put((skey, node, rev))

    def _status_worker(self) -> None:
        """Single controller draining enforcement-status work items
        (cnpNodeStatusController analog) until ``stop()``."""
        while not self._status_stop.is_set():
            try:
                skey, node, rev = self._status_q.get(timeout=0.1)
            except queue.Empty:
                continue
            # the reference's 30 s wait, in slices so stop() ends it
            deadline = time.monotonic() + 30
            ok = False
            while not self._status_stop.is_set():
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                ok = self.daemon.wait_for_policy_revision(
                    rev, timeout=min(left, 0.25))
                if ok:
                    break
            st = self.cnp_status.get(skey, {}).get(node)
            if ok and st is not None and st.get("revision") == rev:
                st["enforcing"] = True
                st["lastUpdated"] = time.time()

    def on_network_policy(self, action: str, obj: Dict) -> None:
        meta = obj.get("metadata") or {}
        key = _policy_key_labels(meta.get("name", ""),
                                 meta.get("namespace", "default"))
        if action in ("added", "modified"):
            rules = parse_network_policy(obj)
            self.daemon.policy_add(rules, replace=True)
        elif action == "deleted":
            self.daemon.policy_delete(key)
        self._count("network-policy")

    # --------------------------------------------------------- services

    def on_service(self, action: str, obj: Dict) -> None:
        """ClusterIP services program the LB (k8s_watcher.go
        addK8sServiceV1)."""
        meta = obj.get("metadata") or {}
        spec = obj.get("spec") or {}
        vip = spec.get("clusterIP")
        key = (meta.get("namespace", "default"), meta.get("name", ""))
        if not vip or vip == "None":
            # headless service: tracked (its Endpoints still drive
            # ToServices translation) but never programmed into the LB
            # (k8s_watcher.go:801-805, :957)
            if action == "deleted":
                self._services.pop(key, None)
            else:
                self._services[key] = {"headless": True,
                                       "ports": spec.get("ports") or []}
            self._count("service")
            return
        if action == "deleted":
            self._services.pop(key, None)
            for p in spec.get("ports") or []:
                self.daemon.service_delete(vip, int(p.get("port", 0)))
        else:
            # a modified spec that drops a port must tear that
            # frontend down, or it keeps forwarding forever
            old = self._services.get(key) or {}
            new_ports = {int(p.get("port", 0))
                         for p in spec.get("ports") or []}
            for p in old.get("ports") or []:
                if int(p.get("port", 0)) not in new_ports:
                    self.daemon.service_delete(
                        old.get("vip", vip), int(p.get("port", 0)))
            self._services[key] = {"headless": False, "vip": vip,
                                   "ports": spec.get("ports") or []}
            backends = self._endpoints.get(key, [])
            for p in spec.get("ports") or []:
                port = int(p.get("port", 0))
                try:
                    target = int(p.get("targetPort") or port)
                except (TypeError, ValueError):
                    # named targetPort: resolving it needs pod specs;
                    # fall back to the service port (reference resolves
                    # through Endpoints ports)
                    target = port
                self.daemon.service_upsert(
                    vip, port, [(ip, target) for ip in backends])
        # the service spec (e.g. targetPort) feeds ingress frontends
        self._resync_ingresses_for(key[0], key[1])
        self._count("service")

    def on_endpoints(self, action: str, obj: Dict) -> None:
        """Endpoints drive both LB backends and ToServices translation
        (k8s_watcher.go addK8sEndpointV1 + rule_translate)."""
        meta = obj.get("metadata") or {}
        key = (meta.get("namespace", "default"), meta.get("name", ""))
        ips = [] if action == "deleted" else endpoints_to_ips(obj)
        rules = self.daemon.repo.rules
        with self._lock:
            # translate inside the lock: two events for the same service
            # applied out of order would leave a decommissioned
            # backend's generated CIDR allowed forever (old_ips of the
            # later event would never name it again)
            old_ips = self._endpoints.get(key, [])
            self._endpoints[key] = ips
            touched = translate_to_services(rules, key[1], key[0], ips,
                                            old_backend_ips=old_ips)
            if touched:
                # Heal shared backends: when two services select the
                # same pod IP, removing this service's old CIDRs also
                # removed the sibling's (ownership can't be inferred
                # from IP containment alone).  Re-translating every
                # other known service re-adds anything it still owns —
                # idempotent, since translate replaces-in-place.
                for (ns, svc), sips in self._endpoints.items():
                    if (ns, svc) != key:
                        translate_to_services(rules, svc, ns, sips)
        if touched:
            # the new backend /32s need CIDR identities + ipcache
            # entries before the regenerated policy can match them
            self.daemon.resync_rule_prefixes(rules)
            self.daemon.trigger_policy_updates("k8s-endpoints")
        self._resync_ingresses_for(key[0], key[1])
        self._count("endpoints")

    # ------------------------------------------------------------- pods

    def on_pod(self, action: str, obj: Dict) -> None:
        """Pods feed the ipcache (podIP -> unmanaged identity until the
        allocator decides — k8s_watcher.go:1964 updatePodHostIP) and
        pod label changes re-resolve the endpoint's identity
        (:2041 updateK8sPodV1)."""
        meta = obj.get("metadata") or {}
        status = obj.get("status") or {}
        spec = obj.get("spec") or {}
        namespace = meta.get("namespace", "default")
        name = meta.get("name", "")
        pkey = (namespace, name)
        pod_ip = status.get("podIP", "")
        host_ip = status.get("hostIP", "")
        if action == "deleted":
            known = self._pod_ips.pop(pkey, "") or pod_ip
            if known:
                self.daemon.ipcache.delete(known, "k8s")
            self._count("pod")
            return
        # ipcache mapping — skipped for host-networking pods or before
        # an IP is assigned, exactly like updatePodHostIP.  A changed
        # podIP (sandbox restart) drops the stale entry first, or IPAM
        # reuse would leave a shadowing unmanaged mapping behind.
        old_ip = self._pod_ips.get(pkey, "")
        if not spec.get("hostNetwork") and pod_ip and host_ip:
            if old_ip and old_ip != pod_ip:
                self.daemon.ipcache.delete(old_ip, "k8s")
            self.daemon.ipcache.upsert(pod_ip, RESERVED_UNMANAGED,
                                       "k8s", host_ip=host_ip,
                                       metadata=f"pod:{namespace}/{name}")
            self._pod_ips[pkey] = pod_ip
        if action == "modified":
            # label updates re-resolve the pod's endpoint identity;
            # namespace meta labels ride along (reference both paths)
            ep = self.daemon.endpoints.lookup_container(
                f"{namespace}/{name}")
            if ep is not None:
                self.daemon.endpoint_update_labels(
                    ep.id, self._merged_labels(
                        ep, namespace, meta.get("labels") or {}))
        self._count("pod")

    def _pod_identity_labels(self, namespace: str,
                             pod_labels: Dict[str, str]) -> List[str]:
        out = [f"k8s:{k}={v}" for k, v in sorted(pod_labels.items())]
        for k, v in sorted(self._ns_labels.get(namespace, {}).items()):
            out.append(f"k8s:{NS_META_PREFIX}.{k}={v}")
        return out

    def _merged_labels(self, ep, namespace: str,
                       pod_labels: Dict[str, str]) -> List[str]:
        """New full label set for the endpoint: its NON-k8s labels are
        preserved (update_labels replaces the whole set — dropping a
        container:/custom label would flip the identity wrongly), k8s
        pod labels + namespace meta labels are rebuilt."""
        keep = [str(lb) for lb in ep.labels.values()
                if lb.source != SOURCE_K8S]
        return keep + self._pod_identity_labels(namespace, pod_labels)

    # ------------------------------------------------------------ nodes

    def on_node(self, action: str, obj: Dict) -> None:
        """Node events program per-node tunneling + ipcache
        (k8s_watcher.go:2303 addK8sNodeV1 -> updateK8sNodeTunneling)."""
        meta = obj.get("metadata") or {}
        spec = obj.get("spec") or {}
        status = obj.get("status") or {}
        name = meta.get("name", "")
        if action == "deleted":
            self.daemon.node_manager.node_deleted(
                f"{self.daemon.config.cluster_name}/{name}")
            self._count("node")
            return
        addresses = [NodeAddress(a.get("type", ""), a.get("address", ""))
                     for a in status.get("addresses") or []]
        node = Node(name=name,
                    cluster=self.daemon.config.cluster_name,
                    addresses=addresses,
                    ipv4_alloc_cidr=spec.get("podCIDR") or None)
        self.daemon.node_manager.node_updated(node)
        self._count("node")

    # ------------------------------------------------------- namespaces

    def on_namespace(self, action: str, obj: Dict) -> None:
        """Namespace label changes re-resolve identities of every
        endpoint in the namespace (k8s_watcher.go:2145
        updateK8sV1Namespace — labels carried under the namespace meta
        prefix)."""
        meta = obj.get("metadata") or {}
        name = meta.get("name", "")
        new_labels = dict(meta.get("labels") or {})
        old_labels = self._ns_labels.get(name, {})
        if action == "deleted":
            self._ns_labels.pop(name, None)
            self._count("namespace")
            return
        self._ns_labels[name] = new_labels
        if new_labels == old_labels:
            self._count("namespace")
            return
        prefix = f"{name}/"
        for ep in self.daemon.endpoints.endpoints():
            cn = ep.container_name or ""
            if not cn.startswith(prefix):
                continue
            pod_labels = {
                lb.key: lb.value for lb in ep.labels.values()
                if lb.source == SOURCE_K8S and
                not lb.key.startswith(NS_META_PREFIX)}
            self.daemon.endpoint_update_labels(
                ep.id, self._merged_labels(ep, name, pod_labels))
        self._count("namespace")

    # ---------------------------------------------------------- ingress

    def on_ingress(self, action: str, obj: Dict) -> None:
        """Single-service ingress -> an external frontend on the host
        address forwarding to the backing service's backends
        (k8s_watcher.go:1376 addIngressV1beta1 + syncExternalLB)."""
        meta = obj.get("metadata") or {}
        spec = obj.get("spec") or {}
        backend = spec.get("backend") or {}
        svc_name = backend.get("serviceName", "")
        if not svc_name:
            self._count("ingress")
            return  # only single-service ingress is supported
        namespace = meta.get("namespace", "default")
        key = (namespace, meta.get("name", ""))
        try:
            port = int(backend.get("servicePort") or 0)
        except (TypeError, ValueError):
            self._count("ingress")
            return
        if action == "deleted":
            self._ingresses.pop(key, None)
            old_port = self._ingress_ports.pop(key, None)
            if old_port:
                self.daemon.service_delete(self.ingress_host_ip,
                                           old_port)
            self._count("ingress")
            return
        # a changed servicePort must drop the old frontend, or traffic
        # to the stale host port keeps forwarding forever
        old_port = self._ingress_ports.get(key)
        if old_port and old_port != port:
            self.daemon.service_delete(self.ingress_host_ip, old_port)
        self._ingresses[key] = (svc_name, port)
        self._program_ingress(key)
        self._count("ingress")

    def _ingress_target_port(self, namespace: str, svc_name: str,
                             service_port: int) -> Optional[int]:
        """Resolve the backing service's targetPort for the ingress
        servicePort (reference resolves through the service spec).
        None when the service is unknown — the frontend must be torn
        down, not re-programmed with a guessed target port."""
        svc = self._services.get((namespace, svc_name))
        if not svc:
            return None
        for p in svc.get("ports") or []:
            if int(p.get("port", 0)) == service_port:
                try:
                    return int(p.get("targetPort") or service_port)
                except (TypeError, ValueError):
                    return service_port  # named port fallback
        return service_port

    def _program_ingress(self, key: tuple) -> None:
        svc_name, port = self._ingresses[key]
        namespace = key[0]
        target = self._ingress_target_port(namespace, svc_name, port)
        if target is None:
            # backing service gone: tear the frontend down rather than
            # forward to a guessed (wrong) pod port
            old_port = self._ingress_ports.pop(key, None)
            if old_port:
                self.daemon.service_delete(self.ingress_host_ip,
                                           old_port)
            return
        backends = self._endpoints.get((namespace, svc_name), [])
        self.daemon.service_upsert(
            self.ingress_host_ip, port,
            [(ip, target) for ip in backends])
        self._ingress_ports[key] = port

    def _resync_ingresses_for(self, namespace: str,
                              svc_name: str) -> None:
        """Endpoints/service churn re-programs dependent ingress
        frontends (syncExternalLB on endpoint events)."""
        for key, (svc, _port) in list(self._ingresses.items()):
            if key[0] == namespace and svc == svc_name:
                self._program_ingress(key)

    # ------------------------------------------------- async dispatch

    _HANDLERS = {
        "cnp": "on_cnp", "networkpolicy": "on_network_policy",
        "service": "on_service", "endpoints": "on_endpoints",
        "pod": "on_pod", "node": "on_node",
        "namespace": "on_namespace", "ingress": "on_ingress",
    }

    _ACTIONS = {"add": "added", "added": "added",
                "modify": "modified", "modified": "modified",
                "delete": "deleted", "deleted": "deleted"}

    def enqueue_event(self, kind: str, action: str, obj: Dict,
                      retries: int = 0) -> bool:
        """Informer-side entry: apply the event asynchronously, in
        arrival order per resource kind, skipping stale duplicates.

        Reference shape: each resource type gets its own
        serializer.FunctionQueue (daemon/k8s_watcher.go's
        serializer per informer) and events carrying an older-or-equal
        resourceVersion than the last seen one for that object are
        dropped (pkg/versioned's equality/staleness check).  Handler
        APPLICATION is serialized by one re-entrant lock across kinds
        — watcher-local state (_services/_endpoints/_ns_labels/...) is
        shared, so per-kind queues give ordering + a non-blocking
        informer thread, not concurrent mutation.  A handler that
        still fails after `retries` attempts (spaced by a short
        backoff) rolls its resourceVersion record back so the
        informer's resync of the same object is NOT dropped as stale.
        Returns False when the event was dropped as stale.
        """
        action = self._ACTIONS[action]          # KeyError on junk
        handler = getattr(self, self._HANDLERS[kind])
        meta = obj.get("metadata", {})
        okey = (kind, meta.get("namespace", ""), meta.get("name", ""))
        # k8s declares resourceVersions opaque; only decimal ones can
        # be ordered — anything else bypasses dedup instead of killing
        # the informer thread
        rv = meta.get("resourceVersion")
        rv_num = int(rv) if isinstance(rv, str) and rv.isdigit() \
            else None
        with self._lock:
            if self._stopped:
                raise RuntimeError("K8sWatcher is stopped")
            prev = self._resource_versions.get(okey)
            if rv_num is not None and action != "deleted":
                if prev is not None and rv_num <= prev:
                    return False  # stale replay/duplicate
                self._resource_versions[okey] = rv_num
            if action == "deleted":
                self._resource_versions.pop(okey, None)
            fq = self._queues.get(kind)
            if fq is None:
                fq = self._queues[kind] = FunctionQueue(name=kind)

        def rollback_rv():
            # un-record this rv so the apiserver's resync of the
            # identical object is not dropped as stale
            with self._lock:
                if self._resource_versions.get(okey) == rv_num:
                    if prev is None:
                        self._resource_versions.pop(okey, None)
                    else:
                        self._resource_versions[okey] = prev

        def wait(n: int) -> bool:
            if n <= retries:
                time.sleep(min(0.05 * n, 0.5))
                return True
            rollback_rv()  # handler gave up
            return False

        def apply():
            with self._apply_lock:
                handler(action, obj)

        try:
            fq.enqueue(apply, wait)
        except RuntimeError:
            # lost the race with stop(): the event will never apply,
            # so its rv must not poison a later restart's dedup
            rollback_rv()
            raise
        return True

    def wait_idle(self, timeout: float = 10.0) -> bool:
        """Barrier: every enqueued event fully applied."""
        with self._lock:
            queues = list(self._queues.values())
        return all(fq.wait_idle(timeout) for fq in queues)

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            queues = list(self._queues.values())
            self._queues.clear()
        for fq in queues:
            fq.stop()
        with self._lock:
            self._status_stop.set()
            worker = self._status_thread
        if worker is not None:
            worker.join(timeout=5.0)

    # ---------------------------------------------------------- plumbing

    def _retranslate(self, rules) -> None:
        with self._lock:
            snapshot = dict(self._endpoints)
        for (ns, svc), ips in snapshot.items():
            translate_to_services(rules, svc, ns, ips)

    def _count(self, kind: str = "other") -> None:
        with self._lock:
            self.events_processed += 1
            self.events_by_kind[kind] = \
                self.events_by_kind.get(kind, 0) + 1
