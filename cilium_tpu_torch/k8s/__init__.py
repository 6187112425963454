"""Kubernetes integration: CRD/NetworkPolicy parsing + translation.

Analog of the reference's ``pkg/k8s``: CiliumNetworkPolicy (CRD) and
k8s NetworkPolicy objects parse into ``policy.api.Rule``s with
namespace scoping injected (pkg/k8s/network_policy.go), and
``ToServices`` rules translate to CIDR sets from Endpoints objects
(pkg/k8s/rule_translate.go). The watcher wires a stream of k8s events
into the daemon (daemon/k8s_watcher.go).

Port of ``cilium_tpu/k8s``: host code over the port's own
``policy.api``, ``policy.jsonio``, ``labels`` and ``Daemon``; the
agent's tables it feeds live on the daemon's device.
"""

from .policy import (parse_cnp, parse_network_policy,
                     NAMESPACE_LABEL_KEY, POLICY_LABEL_NAME,
                     POLICY_LABEL_NAMESPACE)
from .translate import translate_to_services
from .watcher import K8sWatcher

__all__ = ["parse_cnp", "parse_network_policy", "translate_to_services",
           "K8sWatcher", "NAMESPACE_LABEL_KEY", "POLICY_LABEL_NAME",
           "POLICY_LABEL_NAMESPACE"]
