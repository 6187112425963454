#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's verdict and serving paths, its
single-node agent, its agents joined through the kvstore, its sharded
dataplane, its L7 proxy data plane and its host integrations
(Kubernetes, CNI, docker, cilium-health, bugtool, the packing manifest),
on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises and the
script exits non-zero:

1. device: name, compute capability (must be 9.x, Hopper) and power
   limit.
2. build: the kernel ``cilium_tpu_torch/csrc/dense_verdict.cu``
   compiled by nvcc for sm_90a; then its SASS, read by cuobjdump, gives
   the instructions a (packet, entry) pair issues per pipe in the
   verdict kernel's segment loop, from which the kernel's bound is
   computed; a second bound takes the function's own three compares a
   pair on the ALU pipe.
3. refusals: on the card, a table whose endpoints are not contiguous
   raises in ``dense_segments``, and segments of other tables, or of
   tables changed in place since, raise in ``dense_verdict``.  Then
   parity: each kernel's wrapper against its plain PyTorch version on
   the card, bit-exact (tolerance 0: int32 verdicts and counters), on
   ragged batches, many entry tiles, identities >= 2**31, ports >= 32768
   and proxy-port values, and on the edges of the kernel's grouping by
   endpoint: every packet on one endpoint, an endpoint without entries,
   endpoints out of range, every packet deciding on one entry, a
   segment over two tiles, a batch that is no block multiple.
4. config1: the port's config-1 path (ipcache LPM -> 3-stage verdict ->
   per-entry counters) through both engines, hash and dense, at
   B = 2**20 packets for two policy states, BASELINE config 1 (100 rules
   x 16 endpoints) and the 10k-rule north-star state, each on two
   packet streams: the bench's uniform one (the main path) and an
   allow-heavy one (``workloads.config1_allow_heavy_packets``).  Hash
   verdicts must equal dense verdicts, both must equal the scalar
   oracle on a 4,096 packet sample, the dense kernel must have been
   launched, and the kernel must equal its plain version on the whole
   batch (verdicts and every entry's counters).  Then both engines and
   the kernel alone are timed with CUDA events, the kernel's device
   time is split by kernel with torch.profiler (the grouping's share),
   and the plain version is timed on the uniform batch.
5. v4: the v4 stateful serving step (prefilter -> service DNAT ->
   conntrack -> ipcache -> policy -> CT create -> rev-NAT -> overlay)
   through ``Datapath.process_packed`` at the full width of the
   north-star state (``workloads.v4_serving_state``: the 10k-rule policy,
   10,000 services, 1,000 prefilter CIDRs, 256 peer nodes, a 2**20-slot
   conntrack table).  Parity, with the daemon's flow table off and then
   on (4,096 slots, probe 8, the claim on every 4th call): the same port
   on the card and on the CPU, from one seed, 2 batches at B = 2**20
   then 8 at B = 2**16 across a GC and a restore of a conntrack snapshot
   taken mid-run; after every batch verdicts, events, identities, every
   NAT field, the counters, every CT field (sentinel included), every
   flow-table lane and the provenance are compared bit for bit and the
   mismatch counts printed.  Then the no-host-read check
   (``sync_check``): calls on batches already on the card under
   ``torch.cuda.set_sync_debug_mode("error")``, and calls behind a
   half-second ``torch.cuda._sleep``, traced by ``torch.profiler``, that
   must return before the sleep ends or, where a step has more kernels
   than the launch queue holds, show no synchronising or copying CUDA
   runtime call and a kernel launch as what held the host; a control
   step that reads one verdict back must be flagged.  Timing of
   ``process_packed`` (one H2D of the [10, B] matrix from a pinned
   buffer per call) and of ``process`` (ten H2D copies) with CUDA events
   after warm-up batches that fill the table, the table's occupancy,
   the shares of verdicts and events, and a ``torch.profiler``
   breakdown; then, with the flow table on, its occupancy and lost
   share after warm-up, the no-host-read check over claiming and
   claim-free calls, timing and profile.  No hand-written kernel runs
   on this path: the dense kernel's launch count, set to 0 before it,
   is read after it.
6. v6: the same for ``Datapath.process6`` over the v6 twin of that state
   (``workloads.v6_of``: every address embedded in ``fd00::/96``, the
   ICMPv6/NDP responder answering for the node's router, 1% ICMPv6
   traffic): parity with flows and provenance on, the tables' bytes on
   the card, and the no-host-read check, timing and profile with the
   flow table off and on.
7. config2: BASELINE config 2 (``workloads.build_config2``: 10,000
   endpoints x 1,000 exact INGRESS rules, 10M entries, 256 buckets of 8
   slots an endpoint) on the two-choice ``BucketVerdictEngine`` at
   B = 2**20, the identity-l4 bench's traffic (half installed keys, half
   misses).  The host build time and table sizes; the card against the
   same engine on the CPU over 3 batches (every verdict, both counter
   arrays after each); the flat-array oracle on 4,096 packets; a
   smaller mixed-kind case (exact, L3-only and wildcard entries with
   proxy ports, fragments, wrapping byte counters) card against CPU and
   the map-state oracle; the no-host-read check (``no_host_read``);
   CUDA-event timing of 60 batches and a profile.
8. l7: BASELINE configs 3-5 at ``bench_suite.py``'s shapes.  HTTP (4
   rules, 6 paths x 3 methods) and FQDN (3 selectors) at the bench
   batch (32,768) and at 2**20 rows: each engine on the card against a
   CPU twin built with the card's selection, on every row, and Python
   ``re`` (``oracle_match``) on a sample; the host ``encode_packed``
   time; ``match_device`` on pre-encoded blocks already on the card:
   no host read, CUDA-event timing, profile.  Header rules and long
   payloads at the default batch hint (the card selects ``assoc``),
   and every ``DFAEngine`` strategy x dtype, card against CPU.  Kafka
   ACLs run on the host only; their host rate is printed as such.
9. the fused optional stages (``phase_stages``): the v4 state with the
   L7 fast-verdict bench's two redirects on every endpoint
   (``workloads.l7_serving_state``: HTTP ingress :80 -> 15001, DNS
   egress :53 -> 15002, W = 128, a tenth of the pool flows aimed at
   them with payloads from the bench's request and name mix, 5%
   overlong and 5% absent), flows on, v4 then v6.  Legs: ``l7fast``,
   ``threat-shadow`` (every threshold 0), ``threat`` (the enforce leg
   of ``bench_suite.py`` with a redirect arm), ``analytics`` (width
   4,096, depth 2, 4 lanes, stripe 16) and, on v4, ``all-stages``.
   Each leg: the card against the CPU at 2**16 over 3 batches in every
   output and buffer; the HTTP / DNS engines on the rows decided inline,
   ``oracle_threat_step`` and ``oracle_analytics_step`` on the card's
   stage calls; the shadow leg against an engine without the stage;
   then at 2**20, from empty conntrack and flow tables, the verdict
   shares of a first pass, the sync check, 50 timed batches beside the
   flags-off leg's, a profile, and the time of each config, weight and
   epoch swap, with 0 rebuilds.
10. the serving tier (``phase_serving``) on the full-width v4 state with
   flows on, behind the engine's shared lane (``Datapath.serving()``)
   with the daemon's supervision knobs (10 s watchdog, 3 transient
   faults, 1 s reset, 2**17 pending records).  ``serving-parity``: 16
   submitter threads of 6 chunks of 1-4,096 records each (no two records
   share a tuple), every ticket equal to a CPU twin's answer for its
   chunk alone.  ``serving-latency``: ``bench_suite.py``'s latency-tier
   protocol at 1-4,096 records (the sync round trip, the lane unloaded
   and its streaming interval at depth 2; p50/p99 with sample counts
   and the lane's host ms by stage; each timed lane window starts from
   a fresh host view, so no oracle refresh falls in it), then
   ``serving-coalesce``: 16 submitters x 40 single-record frames.
   ``serving-throughput``: 16 submitters of 4,096-record chunks
   coalesced up to 2**15, records/s, the mean batch, and the card's
   busy share in a window under ``torch.profiler``.
   ``verdict-service``: ``VerdictService`` on loopback, 4 clients x 64
   frames (some with a payload lane, some past the lane's max_batch),
   the answers equal to the same records sent straight to the lane.
   ``serving-payload``: the L7 fast verdict on, 2 clients x 24 frames
   with payloads wider than the engine's window through the service,
   every answer equal to the CPU twin's.  Every leg so far must leave
   the lane in mode ok with no fault, no fail-static batch, no failed
   batch and no shed.  ``serving-fault``: 3 transient launch faults,
   then one completion hung past a 0.5 s watchdog; each must take the
   lane fail-static, every row of a seen and of a fresh chunk equal to
   the fail-static precedence over the card's own CT, ipcache and
   policy replay, and once healed the probe must rebuild the tables and
   replay the recovery gate's rows on the card before the lane reads ok
   and equals the CPU twin again.
11. rules to verdicts (``phase_policy``): ``workloads.policy_state``'s
   1,000 rules (L3, L4 with and without ``fromEndpoints``, HTTP on
   targeted rules, egress L3 / L4, ``toCIDR`` / ``fromCIDR``, a few
   ``fromRequires``) over 16 local endpoints, 24 peers and 24 prefixes,
   imported from their JSON text into ``workloads.PolicyRun`` (labels,
   identities, repository, endpoints and their build queue, ipcache,
   proxy redirects, ``DeviceTableManager``, ``Datapath``) on the card.
   ``policy-build``: import and build seconds, regeneration seconds per
   endpoint, entries per endpoint, sync + refresh ms, every endpoint
   ready at the repository's revision.  ``policy-parity``: 2**20 new
   connections through ``process_packed``, every output and buffer
   against a CPU twin built from the same JSON in a worker process
   (its proxy ports renamed to the card's through the redirect ids),
   every identity against the ipcache's own longest match, a 4,096-row
   sample against ``allows_ingress`` / ``allows_egress`` (run in worker
   processes) with redirects against the ``ProxyManager``'s ports, and
   the hash step and the dense step (the CUDA kernel) over
   ``states_by_slot()`` against ``oracle_verdict`` on the whole batch.
   ``policy-timing``: ``process_packed``, both steps and the kernel, 25
   timed calls each.  ``policy-propagation``: on a BASELINE-config-1
   sized state (100 rules), 10 single-rule adds and 10 deletes, each
   timed to the engine's ``on_revision_served`` and to the batch in
   which the flow it opens or closes flips.
12. the single-node agent (``phase_daemon``): ``Daemon`` on the card
   with its REST API on port 0 and a state directory in the build
   directory, the ``phase_policy`` state entered as a user enters it
   (``PUT /endpoint/{id}`` for the 16 endpoints, the 24 peers as the
   kvstore watchers enter them, the rules' JSON through ``PUT
   /policy``).  ``daemon-start``: agent start and import-to-ready
   seconds, every endpoint ready.  ``daemon-parity``: the 2**20-row batch
   through the agent's ``process_packed`` against ``phase_policy``'s
   ``PolicyRun`` on the same batch, both from an empty conntrack table
   and zeroed counters, every output, CT field, per-entry counter and
   map state (ports renamed by redirect id); ``POST /debug/drift-audit``
   with 0 divergences; ``HostVerdictPath`` against the card's policy
   tables on 4,096 rows.  ``daemon-timing``: ``process_packed``, 50
   timed calls at 2**20, and the p50 of ``GET /healthz`` and ``GET
   /policy``.  ``daemon-cli``: ``status`` and ``policy trace --replay``
   through ``cli.main``, exit 0.  ``daemon-restart``: ``checkpoint_ct``,
   shutdown, a new agent on the state directory: 16 endpoints and every
   CT entry restored, and every row whose flow had an entry keeps its
   verdict.  No hand-written kernel runs on this path: the dense
   kernel's launch count, set to 0 before the phase, is read after it.
13. the cluster control plane (``phase_kvstore``): the port's
   ``MiniEtcd`` on loopback and three agents on the card over the
   propagation state (100 rules), cluster id 3 (every identity above
   2**16).  A (``node-a``, the outage guard's degrade on) reaches the
   store through a ``FaultProxy`` and holds the 16 endpoints and the
   rules (over REST); B (``node-b``) holds the 24 peers as its own
   endpoints and registers its node with a pod CIDR, so they reach A
   only through the store; R has no store and is given the peers and
   B's node by hand.  ``kvstore-converge``: seconds until the 24 peer
   IPs resolve to B's identities in A's ipcache LPM on the card, until
   B's pod CIDR resolves to B's node in A's tunnel LPM on the card, and
   until A's map states equal R's; identities equal on A and B for
   every label set.  ``kvstore-parity``: 2**20 new connections through
   A and R, every output, CT field, per-entry counter and map state
   equal (identities renamed by labels, ports by redirect id).
   ``kvstore-outage``: the proxy blackholed: seconds to ``degraded``,
   a held 2**16-row batch unchanged from the same CT state; an endpoint
   added over REST on a node-local identity; the proxy healed: seconds
   to ``ok`` with the identity promoted, the degraded, reconciling and
   recovered flight-recorder events, and that endpoint's traffic and
   map states equal to R's with the same endpoint added.
14. the sharded dataplane (``phase_sharded``): four ep-shards on the
   card (``ShardedDatapath(n_shards=4, devices=[cuda:0] * 4)``, a
   2**20-slot CT each) over the full-width v4 state, flows at the
   daemon's defaults and provenance on.  ``sharded-twin``: the same
   plane on the card and on the CPU (``devices=[cpu] * 4``), 2**16 rows
   through every shard's ``process_packed`` at one clock, every output,
   provenance, CT field, counter and flow-table lane compared.
   ``sharded-parity``: from empty CT tables, 2**20 rows of the v4 pool
   through ``classify_records`` against one engine's lane: verdict and
   identity on every row whose 5-tuple stays on one shard, per-entry
   counters by global slot, the union of the shards' live CT keys, and
   the count of rows whose 5-tuple crosses shards (the CT key carries
   no endpoint).  ``sharded-kill``: a fatal launch fault on shard 1
   (``DeviceFaultInjector``): the status names ``[1]``, the siblings
   equal the single engine with closed breakers, shard 1 serves
   fail-static with its established flows kept, and gated recovery
   restores ``ok``; seconds to fail-static and to recovery.
   ``sharded-timing``: ``classify_records`` at 2**15 and 2**20 rows,
   sharded against one engine (median, p99, samples, records/s, the
   card's busy share).  ``sharded-dfa``: the config-3 HTTP DFA over
   1,024-byte request lines, ``dfa_scan_sharded`` over four chunks on
   the card against the serial ``dfa_scan``, 0 mismatches, with ``S``
   and both times.  ``sharded-agent``: ``Daemon(DaemonConfig(
   dataplane_shards=4))`` on the card over REST on the propagation
   state: geometry, every endpoint's rows on its owning shard only,
   ``/flows?shard=k`` shard-attributed, a shard fault named in the
   status until recovery.
15. the L7 proxy data plane (``phase_proxy``).  ``proxy-l7``: 4,096
   ``l7_frame`` rows over the stage legs' ``l7_serving_state`` through
   the v4 step on the card with the L7 fast stage on; every HTTP row the
   card redirected (absent or overlong payloads) or decided inline sends
   its request over TCP through a ``SocketProxy`` listening at the port
   the card answered, in front of a loopback upstream: the proxy's
   verdicts against the redirect's ``HTTPPolicyEngine`` and the ``re``
   oracle, and on the inline rows against the card's tier; the proxied
   connections (``proxy_stats``).  ``proxy-batched``: 256 concurrent
   connections through ``SocketProxy(http_batch_window=0.002)`` with the
   HTTP engine on the card: batches, largest batch, errors, verdicts
   against the scalar tier, and the DFA walk's kernels on the card
   (``torch.profiler``).  ``proxy-reentry``: the marked upstream leg of
   a proxied memcached connection as ``mark_identity`` of a v4 batch,
   card against CPU, the unmarked twin WORLD.  ``proxy-xds``:
   ``Daemon(device=cuda:0).serve_xds()`` and ``ProxySupervisor(device=
   "cuda:0")``; a redirect made through ``PUT /policy`` enforced on live
   TCP; seconds to the child's first ACK, to enforcement after ``kill
   -9``, to a second import's ACK.  ``nat-csum``: ``nat_csum_fix`` (TCP
   and UDP), ``csum_update_u32``, ``checksum16`` and NAT46/64 on 2**20
   seeded rows, card against CPU, the incremental fix against the
   recomputed checksum.
16. the host integrations (``phase_hostint``): ``workloads.policy_state``'s
   1,000 rules over 16 local pods and 24 remote ones as Kubernetes
   objects in the port's ``FakeAPIServer`` (every other rule a
   NetworkPolicy can say as one, the rest CNPs; 8 CNPs whose egress
   names a service), 256 Nodes with pod CIDRs and v4 / v6 addresses,
   1,000 ClusterIP Services of 4 pod backends with their Endpoints.
   Agent A on the card takes its pods through CNI ADD over its REST API
   and the rest through ``K8sTransport`` and ``K8sWatcher``; the twin B
   gets the same pods through CNI ADD and the rest by hand (the pods'
   addresses as the watcher enters them, ``node_updated``, the rules
   from ``parse_cnp`` / ``parse_network_policy`` with the services'
   backends translated in, ``service_upsert``).  ``k8s-sync``: seconds
   from ``start()`` to every endpoint ready with the tunnel map, the
   pods and the services on A's card (the Services are created after
   the first sync: the watcher programs a service's backends on its
   Service event, as the reference's does; the pods come after the
   policies, one by one as kubelet runs them, and a
   ``trigger_policy_updates`` round follows them, since the local
   identity allocator rebuilds nothing when a later pod's identity
   appears: ``k8s_sync`` reports the round's seconds and the map-state
   entries it changed); 2**20 rows, 4,096 of them to
   service VIPs, through both agents, every output and buffer equal
   (identities renamed by labels, proxy ports by redirect id), each VIP
   row DNAT'd to one of its service's backends.
   ``k8s-propagation`` (in a worker process beside ``k8s-sync``, with
   ``packing``): ``policy-propagation``'s state (100 rules) behind its
   own apiserver: 10 CNP upserts and 10 deletes, each timed from
   ``FakeAPIServer.upsert`` / ``delete`` to the batch in which the flow
   it opens or closes flips on the card.  ``k8s-relist``: a marker
   namespace, ``compact()`` and ``disconnect_watchers()``: every other
   reflector relists, the resourceVersion dedup skips every object it
   re-delivers, no event applies, and 2**16 rows keep their verdicts
   from the same CT state.  ``cni-docker``: on both agents a CNI ADD,
   a libnetwork RequestAddress / CreateEndpoint / Join over the
   plugin's HTTP, a ``WorkloadWatcher`` start, and (on A) a container
   started in a small dockerd on a unix socket that a
   ``DockerEventWatcher`` follows: each endpoint's rows equal the twin's
   and, where a rule selects it, some are allowed; after CNI DEL,
   Leave, the stop and die events no row is.  ``health``:
   ``HealthProber`` over A's nodes with ``make_icmp6_probe``, 32 nodes
   and A's own served by an engine on the card (one ``process6`` row a
   probe): exactly those reachable; TCP probes against a
   ``HealthResponder`` healthy, then not after it shuts down.
   ``bugtool``: ``collect_remote`` and ``collect`` against A: the
   members, none failed, and ``status.json`` naming the card.
   ``packing``: the manifest of the full-width v4 and v6 serving tables
   on the card, the unpacked views equal to the leaves and inside the
   group buffers, a v4 step on the views against the step on the
   tables at 2**20 rows from the same CT state, and policy rows written
   by ``refresh_policy`` against ``make_policy_row_writer``'s.
17. the kernels line (the dense kernel's launches on the config-2, L7,
   stage, serving, agent, kvstore, sharded, proxy and host-integration
   paths, 0, beside those of v4, v6 and the policy path), the card's
   name and power limit from nvidia-smi, and a last line ``{"ok": true,
   "device": {...}}``.

Without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import ipaddress
import json
import multiprocessing
import os
import shutil
import signal
import socket
import socketserver
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from collections import deque

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from cilium_tpu_torch import (bugtool, convert, docker_plugin, health,
                              kernels, runtime_watch, sass_mix)
from cilium_tpu_torch import cni as cni_mod
from cilium_tpu_torch.analytics.decode import (quiesced_section,
                                               top_prefixes, top_scanners,
                                               top_talkers)
from cilium_tpu_torch.analytics.oracle import oracle_analytics_step
from cilium_tpu_torch.cli import Client
from cilium_tpu_torch.cli import main as cli_main
from cilium_tpu_torch.compiler.bucket_tables import compile_states_bucketed
from cilium_tpu_torch.compiler.lpm import (LPM_MISS, compile_lpm,
                                           ipv4_to_u32, oracle_lpm_u32,
                                           parse_prefixes)
from cilium_tpu_torch.compiler.policy_tables import (compile_endpoints,
                                                     oracle_verdict)
from cilium_tpu_torch.compiler.regexc import (compile_regex_set,
                                              oracle_match)
from cilium_tpu_torch.daemon import Daemon
from cilium_tpu_torch.daemon.rest import APIServer
from cilium_tpu_torch.datapath import (conntrack, csum, engine, events,
                                       nat46, pipeline)
from cilium_tpu_torch.datapath.codes import (VERDICT_DROP, VERDICT_DROP_L7,
                                             WORLD_IDENTITY)
from cilium_tpu_torch.datapath.pipeline import (PACKED_FIELDS,
                                                RawPacketBatch,
                                                host_fail_static_step,
                                                make_step)
from cilium_tpu_torch.datapath.serving import VerdictDispatcher
from cilium_tpu_torch.datapath.supervisor import DeviceSupervisor
from cilium_tpu_torch.device import cuda_ms, host_buffer, nvidia_smi, probe
from cilium_tpu_torch.hubble.aggregation import EVENT_BIAS
from cilium_tpu_torch.endpoint.tables import DeviceTableManager
from cilium_tpu_torch.identity import (RESERVED_UNMANAGED, IdentityCache,
                                       is_local_scope_identity)
from cilium_tpu_torch.ipcache.ipcache import SOURCE_KVSTORE
from cilium_tpu_torch.k8s import K8sWatcher
from cilium_tpu_torch.k8s import parse_cnp as k8s_parse_cnp
from cilium_tpu_torch.k8s import \
    parse_network_policy as k8s_parse_network_policy
from cilium_tpu_torch.k8s import translate as k8s_translate
from cilium_tpu_torch.k8s.client import K8sTransport
from cilium_tpu_torch.k8s.fake_apiserver import FakeAPIServer
from cilium_tpu_torch.kvstore import EtcdBackend, MiniEtcd
from cilium_tpu_torch.l7.dns import DNSPolicyEngine
from cilium_tpu_torch.l7.fast import encode_payloads
from cilium_tpu_torch.l7.http import (HTTPPolicyEngine, HTTPRequest,
                                      rule_to_combined_regex)
from cilium_tpu_torch.l7.http import request_line as http_request_line
from cilium_tpu_torch.l7.kafka import KafkaPolicyEngine
from cilium_tpu_torch.l7.parser import PortRuleL7
from cilium_tpu_torch.l7.socket_proxy import ListenerContext, SocketProxy
from cilium_tpu_torch.l7.supervisor import ProxySupervisor
from cilium_tpu_torch.labels import LabelArray, Labels
from cilium_tpu_torch.native import PKT_HEADER_DTYPE
from cilium_tpu_torch.node import Node, NodeAddress
from cilium_tpu_torch.observability import stages
from cilium_tpu_torch.ops import dense_verdict as dv
from cilium_tpu_torch.ops.bucket_ops import BucketVerdictEngine
from cilium_tpu_torch.ops import dfa_ops
from cilium_tpu_torch.ops.dfa_engine import DFAEngine
from cilium_tpu_torch.ops.dfa_parallel import dfa_scan_sharded
from cilium_tpu_torch.ops.lpm_ops import lpm_lookup
from cilium_tpu_torch.parallel import ShardedDatapath, make_mesh, packing
from cilium_tpu_torch.parallel.mesh import DP_AXIS
from cilium_tpu_torch.policy.api import Decision, PortRuleHTTP
from cilium_tpu_torch.policy.jsonio import rules_from_json
from cilium_tpu_torch.policy.mapstate import (PolicyKey, PolicyMapState,
                                              PolicyMapStateEntry)
from cilium_tpu_torch.policy.repository import Repository
from cilium_tpu_torch.policy.trace import Port, SearchContext
from cilium_tpu_torch.profile_config1 import (V4_WARMUP, profile_run,
                                              profile_step)
from cilium_tpu_torch.proxy import AccessLog, PROXY_PORT_MAX, proxy_id
from cilium_tpu_torch.threat.model import ThreatConfig, default_model
from cilium_tpu_torch.threat.oracle import oracle_threat_step
from cilium_tpu_torch.threat.trainer import ThreatTrainer
from cilium_tpu_torch.utils.faultinject import (ControlPlaneFaultInjector,
                                                DeviceFaultInjector,
                                                FaultProxy)
from cilium_tpu_torch.utils.option import DaemonConfig
from cilium_tpu_torch.xds import TYPE_NETWORK_POLICY
from cilium_tpu_torch.verdict_service import (VerdictClient, VerdictService,
                                              _decode_wire_payloads,
                                              pack_wire_payloads)
from cilium_tpu_torch.workloads import (ANALYTICS, CONFIG2_FIELDS,
                                        FQDN_SELECTORS, HTTP_RULES,
                                        KAFKA_RULES, L7_BAD_SHARES,
                                        L7_DNS_NAMES, L7_FLOW_SHARE,
                                        L7_HTTP_PORT,
                                        L7_WINDOW, POLICY_APPS,
                                        POLICY_ENDPOINT_ID_BASE,
                                        THREAT, TRAFFICS,
                                        V4_T0, Config1Run, Config2Run,
                                        PolicyRun, V4Run, V6Run,
                                        build_config2,
                                        config3_requests, config4_requests,
                                        config5_names, l7_serving_packets,
                                        l7_serving_packets6,
                                        l7_serving_state,
                                        mixed_bucket_packets,
                                        mixed_bucket_states,
                                        policy_packets, policy_remotes,
                                        policy_state,
                                        threat_enforce_config, unpack6,
                                        v4_serving_packets,
                                        v4_serving_state, v6_of,
                                        v6_serving_packets)

BATCH = 1 << 20
ORACLE_SAMPLE = 4096
# H100 SXM HBM3 rate (NVIDIA data sheet).  The operation rate is the
# card's own: its SM count and maximum SM clock, with the per-pipe lanes
# of cilium_tpu_torch/sass_mix.py, applied to the instructions the built
# kernel issues per (packet, entry) pair (read from its SASS).
HBM_BYTES_PER_S = 3.35e12


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def device_breakdown(fn, calls: int) -> dict:
    """Device ms per call of each kernel (and memset) that ``fn``
    launches, from ``torch.profiler`` over ``calls`` calls after a
    warm-up; {} where the profiler records no device time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:96]: e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


# the kernels of csrc/dense_verdict.cu that group the packets by endpoint
GROUPING = ("histogram_kernel", "scan_kernel", "scatter_kernel")


# Equality compares a (packet, entry) pair needs whatever the kernel:
# identity, exact meta word, L3 meta word.  The wildcard test (key_a ==
# 0) is one per entry, not per pair.
FUNCTION_COMPARES_PER_PAIR = 3


def dense_bound_ms(tables, pkt_ep, pair_s: float,
                   function_pair_s: float) -> dict:
    """Least time for the dense verdict's work on the card: the larger of
    its bytes (entries read once, packets read once, verdicts and the
    two counter arrays written once) over the memory rate and its pairs
    at ``pair_s`` seconds each (the kernel's per-pair instructions from
    its SASS over the card's rate for their pipe).  ``bound_ms`` counts
    the pairs this run's data needs: each packet against its own
    endpoint's entries.  ``function_bound_ms`` takes the same pairs at
    ``function_pair_s``, the function's own compares a pair on the ALU
    pipe, whatever any kernel spends beside them.  ``all_pairs_bound_ms``
    counts every (packet, entry) pair at ``pair_s``."""
    n, b = int(tables.ep.shape[0]), int(pkt_ep.shape[0])
    real = tables.ep[tables.ep >= 0].to(torch.int64)
    per_ep = torch.bincount(real)
    ep = pkt_ep[(pkt_ep >= 0) & (pkt_ep < per_ep.shape[0])]
    pairs = int(per_ep[ep.to(torch.int64)].sum())
    t_bytes = 4 * (4 * n + 6 * b + b + 2 * n) / HBM_BYTES_PER_S * 1e3
    t_ops = pairs * pair_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "pairs": pairs,
            "function_bound_ms": max(t_bytes,
                                     pairs * function_pair_s * 1e3),
            "all_pairs_bound_ms": max(t_bytes, b * n * pair_s * 1e3)}


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain version
# ---------------------------------------------------------------------------

def _random_states(n_endpoints, n_rules, seed, wide, pool=16):
    """Random per-endpoint states over ``pool`` identities and ports;
    ``wide`` draws identities >= 2**31 and ports >= 32768 too.  Every
    state carries L3-only and wildcard keys and proxy-port values."""
    rng = np.random.default_rng(seed)
    idents = rng.integers(256, 4096, pool)
    ports = rng.integers(1, 2048, pool)
    if wide:
        idents = np.r_[idents, rng.integers(2 ** 31, 2 ** 32, 8)]
        ports = np.r_[ports, rng.integers(32768, 65536, 8)]
    states = []
    for _ in range(n_endpoints):
        st = PolicyMapState()
        for _ in range(n_rules):
            st[PolicyKey(identity=int(rng.choice(idents)),
                         dest_port=int(rng.choice(ports)), nexthdr=6,
                         direction=int(rng.integers(0, 2)))] = \
                PolicyMapStateEntry(proxy_port=int(rng.integers(0, 3) *
                                                   11000))
        st[PolicyKey(identity=int(rng.choice(idents)))] = \
            PolicyMapStateEntry()
        st[PolicyKey(identity=0, dest_port=80, nexthdr=6)] = \
            PolicyMapStateEntry(proxy_port=15001)
        states.append(st)
    return states, idents, ports


def _random_packets(n_endpoints, idents, ports, batch, seed):
    rng = np.random.default_rng(seed)
    ident_pool = np.r_[idents, rng.integers(0, 2 ** 32, 16)]
    cols = (rng.integers(0, n_endpoints, batch),
            ident_pool.astype(np.uint32).view(np.int32)[
                rng.integers(0, len(ident_pool), batch)],
            rng.choice(np.r_[ports, 80, 0], batch),
            rng.choice([6, 6, 6, 0, 17], batch),
            rng.integers(0, 2, batch),
            rng.integers(40, 65536, batch))
    return [np.asarray(c, np.int32) for c in cols]


def compare_dense(tables, pkts, segments) -> dict:
    """Kernel (``dense_verdict``) vs plain version on the same tensors;
    raises unless verdict and both counter deltas are bit-equal."""
    got = dv.dense_verdict(tables, *pkts, segments=segments)
    want = dv.dense_verdict_reference(tables, *pkts)
    torch.cuda.synchronize()
    err = 0
    for name, g, w in zip(("verdict", "d_packets", "d_bytes"), got, want):
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"dense_verdict kernel != plain: {name}")
        err = max(err, int((g.to(torch.int64) - w).abs().max().item())
                  if g.numel() else 0)
    v = got[0]
    return {"max_abs_err": err, "b": int(pkts[0].shape[0]),
            "n": int(tables.ep.shape[0]),
            "drops": int((v == VERDICT_DROP).sum()),
            "allows": int((v == 0).sum()),
            "proxied": int((v > 0).sum())}


def _case(n_ep, n_rules, batch, seed, wide, pool=16):
    states, idents, ports = _random_states(n_ep, n_rules, 100 + seed, wide,
                                           pool)
    return states, _random_packets(n_ep, idents, ports, batch, 200 + seed)


def _parity_cases():
    """(name, map states, packet columns on the host) of each parity
    case.  The first four hold the kernel's tails and key ranges; the
    rest the edges of its grouping: one endpoint for every packet, an
    endpoint with no entries, endpoints out of range, every packet on
    one entry, a segment over two tiles with a ragged tail, a batch that
    is no multiple of a verdict block (512 packets) or of a grouping
    block (4,096), and more endpoints than a grouping block counts in
    shared memory."""
    yield ("ragged-b1000", *_case(4, 24, 1000, 0, False))
    yield ("ragged-b4097-wide", *_case(8, 60, 4097, 1, True))
    yield ("many-tiles-n-not-tile-multiple",
           *_case(16, 700, 1 << 14, 2, True))
    yield ("one-packet", *_case(3, 10, 1, 3, True))

    states, pk = _case(4, 60, 1 << 20, 4, True)
    pk[0][:] = 2
    yield "one-endpoint-all-2^20-packets", states, pk

    states, pk = _case(5, 40, 1 << 16, 5, True)
    states[1] = PolicyMapState()  # receives packets, holds no entry
    states[4] = PolicyMapState()  # beyond the last real row: E = 4
    yield "endpoint-without-entries", states, pk

    states, pk = _case(6, 40, 1 << 16, 6, True)
    rng = np.random.default_rng(6)
    odd = rng.random(pk[0].shape[0]) < 0.3
    pk[0][odd] = rng.choice(np.array([-1, -5, 6, 7, 1 << 20, -(1 << 31)],
                                     np.int32), int(odd.sum()))
    yield "endpoints-out-of-range", states, pk

    st = PolicyMapState()
    st[PolicyKey(identity=0, dest_port=80, nexthdr=6)] = \
        PolicyMapStateEntry(proxy_port=15001)
    _, pk = _case(1, 1, 1 << 20, 7, True)
    pk[0][:], pk[2][:], pk[3][:], pk[4][:] = 0, 80, 6, 0
    yield "every-packet-on-one-entry", [st], pk

    states, pk = _case(2, 3000, 1 << 14, 8, True, pool=64)
    yield "segment-over-two-tiles-ragged", states, pk

    yield ("b-not-block-multiple", *_case(6, 80, 5 * 1024 + 77, 9, True))

    # more endpoints than a grouping block keeps bins for in shared
    # memory (4,096): the bins are bumped in global memory instead
    yield ("endpoints-over-shared-bins", *_case(4100, 2, 1 << 16, 10, True))


def phase_refusals(dev) -> None:
    """On the card: a table whose endpoints are not contiguous is
    refused by ``dense_segments``; segments of other tables with the same
    N and E, or of tables changed in place since, by ``dense_verdict``."""
    col = torch.tensor([0, 0, 1, 0] + [-1] * 124, dtype=torch.int32,
                       device=dev)
    split = dv.DenseTables(col, col.clone(), col.clone(), col.clone())
    refused = []
    try:
        dv.dense_segments(split)
    except ValueError as exc:
        refused.append(str(exc))
    states, pk = _case(4, 24, 1000, 0, False)
    tables = dv.compile_dense(states, device=dev)
    twin = dv.compile_dense(states, device=dev)
    pkts = tuple(torch.as_tensor(c, device=dev) for c in pk)
    for name, segments in (("other-tables", dv.dense_segments(twin)),
                           ("changed-in-place",
                            dv.dense_segments(tables))):
        if name == "changed-in-place":
            tables.value.add_(1)
        try:
            dv.dense_verdict(tables, *pkts, segments=segments)
        except ValueError as exc:
            refused.append(str(exc))
    if len(refused) != 3:
        raise AssertionError(f"refused {len(refused)} of 3: {refused}")
    emit("refusals", kernel="dense_verdict", refused=refused)


def phase_parity(dev) -> float:
    worst = 0
    for name, states, pk in _parity_cases():
        tables = dv.compile_dense(states, device=dev)
        segments = dv.dense_segments(tables)
        pkts = tuple(torch.as_tensor(c, device=dev) for c in pk)
        res = compare_dense(tables, pkts, segments)
        seg = np.diff(segments.offsets.cpu().numpy())
        # kTile = 1024 entries in csrc/dense_verdict.cu
        if name.startswith("many-tiles") and res["n"] % 1024 == 0:
            raise AssertionError("entry count must not be a tile multiple")
        if name.startswith("segment-over") and \
                not (seg.max() > 2048 and seg.max() % 1024):
            raise AssertionError(f"{name}: segments {seg.tolist()}")
        if name.startswith("every-packet") and \
                res["allows"] + res["proxied"] != res["b"]:
            raise AssertionError(f"{name}: not every packet decided")
        if name.startswith("endpoints-over") and \
                segments.n_endpoints <= 4096:
            raise AssertionError(f"{name}: {segments.n_endpoints} endpoints")
        if name.startswith("endpoint-without") and \
                (segments.n_endpoints != 4 or seg[1] != 0):
            raise AssertionError(f"{name}: segments {seg.tolist()}")
        if res["b"] > 1 and not name.startswith("every-packet") and \
                (res["allows"] == 0 or res["proxied"] == 0):
            raise AssertionError(f"{name}: no allow or proxy verdicts")
        worst = max(worst, res["max_abs_err"])
        emit("parity", kernel="dense_verdict", case=name,
             endpoints=segments.n_endpoints, longest_segment=int(seg.max())
             if seg.size else 0, **res)
    return worst


# ---------------------------------------------------------------------------
# phase 4: the config-1 path
# ---------------------------------------------------------------------------

def run_traffic(run, label, traffic, oracle_sample, iters, pair_s,
                function_pair_s) -> dict:
    """Drive ``run`` (a ``Config1Run``) on the packet stream ``traffic``:
    one step through each engine with the kernel's launches counted from
    0, the checks, the whole-batch kernel = plain check, then the timed
    calls.  ``iters``: {"hash": n, "dense": n, "kernel": n, "plain": n}
    timed calls (plain 0: not timed); ``pair_s`` and ``function_pair_s``:
    least seconds per (packet, entry) pair, from the kernel's SASS and
    from the function's own compares."""
    run.set_traffic(traffic)
    batch = run.batch
    torch.cuda.reset_peak_memory_stats()
    dv.dense_verdict.launches = 0
    hv, hident, h_counters = run.hash_step()
    dvv, dident, d_pk, d_by = run.dense_step()
    torch.cuda.synchronize()
    launches = dv.dense_verdict.launches
    if launches < 1:
        raise AssertionError("dense_verdict kernel was not launched")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    where = f"{label} ({traffic})"
    if not torch.equal(hv, dvv):
        raise AssertionError(f"{where}: hash verdicts != dense verdicts")
    if not torch.equal(hident, dident):
        raise AssertionError(f"{where}: hash identities != dense")
    pk = run.pkt
    passed = hv != VERDICT_DROP
    non_drop = int(passed.sum())
    counted = {"hash": int(h_counters.packets.sum(dtype=torch.int64)),
               "dense": int(d_pk.sum(dtype=torch.int64))}
    if counted["hash"] != non_drop or counted["dense"] != non_drop:
        raise AssertionError(f"{where}: counted {counted} != non-drop "
                             f"{non_drop}")
    want_bytes = int(pk["length"][passed].sum(dtype=torch.int64))
    if int(d_by.sum(dtype=torch.int64)) != want_bytes:
        raise AssertionError(f"{where}: dense byte counters off")

    # scalar oracle on a sample, spread over the batch
    idx = np.linspace(0, batch - 1, min(oracle_sample, batch)).astype(int)
    parsed = parse_prefixes(run.prefixes)
    v_host, id_host = hv.cpu().numpy(), hident.cpu().numpy()
    host = run.host
    src = host["src_addr"].view(np.uint32)
    for i in idx:
        want_id = oracle_lpm_u32(parsed, int(src[i]))
        want_id = WORLD_IDENTITY if want_id == LPM_MISS else want_id
        want_v = oracle_verdict(run.states[host["endpoint"][i]], want_id,
                                int(host["dport"][i]), 6, 1)
        if id_host[i] != want_id or v_host[i] != want_v:
            raise AssertionError(f"{where}: packet {i} oracle mismatch")

    # the kernel against its plain version on the whole batch: verdicts
    # and every entry's packet and byte deltas
    args = (pk["endpoint"], dident, pk["dport"], pk["proto"],
            pk["direction"], pk["length"])
    parity = compare_dense(run.dense, args, run.segments)

    # timing: each engine's whole step, then the kernel alone
    engines = {}
    for name, fn in (("hash", run.hash_step), ("dense", run.dense_step)):
        ms = cuda_ms(fn, iters[name])
        engines[name] = {
            "verdicts_per_s": batch * len(ms) / (sum(ms) / 1e3),
            "median_batch_ms": float(np.median(ms)),
            "p99_batch_ms": float(np.percentile(ms, 99)),
            "max_batch_ms": float(max(ms)), "samples": len(ms)}

    def kernel_once():
        dv.dense_verdict(run.dense, *args, segments=run.segments)

    k_ms = cuda_ms(kernel_once, iters["kernel"])
    parts = device_breakdown(kernel_once, 3)
    grouping = sum(ms for name, ms in parts.items()
                   if any(g in name for g in GROUPING))
    result = {"label": label, "traffic": traffic, "batch": batch,
              "entries": int(run.dense.ep.shape[0]),
              "launches": launches, "non_drop": non_drop,
              "oracle_sample": len(idx), "peak_gb": peak_gb,
              "engines": engines, "kernel_ms": float(np.median(k_ms)),
              "kernel_samples": len(k_ms), "parity": parity,
              "device_breakdown": parts,
              "grouping_share": grouping / sum(parts.values())
              if parts else None,
              **dense_bound_ms(run.dense, pk["endpoint"], pair_s,
                               function_pair_s)}
    if iters["plain"]:
        result["plain_ms"] = float(np.median(cuda_ms(
            lambda: dv.dense_verdict_reference(run.dense, *args),
            iters["plain"])))
    emit("config1", **result)
    return result


def run_state(label, n_rules, dev, batch, oracle_sample, iters, pair_s,
              function_pair_s) -> dict:
    """One policy state through both traffics; ``iters`` maps each
    traffic to ``run_traffic``'s timed calls.  The uniform stream, the
    bench's, runs first: it is the main path."""
    t0 = time.perf_counter()
    run = Config1Run(n_rules, batch, dev)
    torch.cuda.synchronize()
    emit("state", label=label, rules=n_rules,
         entries=int(run.dense.ep.shape[0]),
         endpoints=run.segments.n_endpoints,
         lpm_prefixes=len(run.prefixes), policy_slots=run.compiled.slots,
         policy_probe=run.compiled.max_probe, lpm_slots=run.lpm.slots,
         lpm_probe=run.lpm.max_probe,
         setup_s=time.perf_counter() - t0)
    return {traffic: run_traffic(run, label, traffic, oracle_sample,
                                 iters[traffic], pair_s, function_pair_s)
            for traffic in TRAFFICS}


# ---------------------------------------------------------------------------
# phases 5 and 6: the v4 and v6 stateful steps
# ---------------------------------------------------------------------------

V4_STATE = {}           # v4_serving_state() arguments: full width
V4_BATCH = 1 << 20
V4_SMALL = 1 << 16
V4_FLOWS = 1 << 16
V4_CT_SLOTS = 1 << 20
V4_CT_PROBE = 8
V4_TIMED = {"process_packed": 40, "process": 20, "flows": 30}
V6_TIMED = {"off": 30, "flows": 30}
# the daemon's flow table (DaemonConfig hubble_flow_slots / probe) and
# the engine's claim stripe
FLOW_SLOTS = 1 << 12
FLOW_PROBE = 8
FLOW_CLAIM_EVERY = 4
# batches served with flows on before their timing, to fill the table
FLOW_WARMUP = 8
# about half a second of torch.cuda._sleep at the H100's 1.98 GHz
SLEEP_CYCLES = 1_000_000_000


def enable_flows(dp) -> None:
    dp.enable_flow_aggregation(slots=FLOW_SLOTS, max_probe=FLOW_PROBE,
                               claim_every=FLOW_CLAIM_EVERY)


def mismatches(outs_g, outs_c, gpu, cpu, family6: bool) -> dict:
    """Elements that differ between the card's and the CPU's step, per
    output: verdict, event, identity, every NAT field, both counters,
    every field of the family's CT (sentinel included, the discard slot
    left out), every lane of the flow table when it is on, and the
    provenance slot and tier."""
    pairs = [(name, g, c) for name, g, c in
             zip(("verdict", "event", "identity"), outs_g[:3], outs_c[:3])]
    pairs += [(f"nat.{f}", getattr(outs_g[3], f), getattr(outs_c[3], f))
              for f in outs_g[3]._fields]
    pairs += [(f"counters.{f}", getattr(gpu.counters, f),
               getattr(cpu.counters, f)) for f in ("packets", "bytes")]
    ct_g, ct_c = (gpu.ct6, cpu.ct6) if family6 else (gpu.ct, cpu.ct)
    n = ct_g.slots + 1
    ct_name = "ct6" if family6 else "ct"
    pairs += [(f"{ct_name}.{f}", ct_g.state[i, :n], ct_c.state[i, :n])
              for i, f in enumerate(conntrack.FIELDS)]
    if gpu.flows is not None:
        for lane, f in enumerate(("src", "dst", "meta", "last_seen")):
            pairs.append((f"flows.{f}", gpu.flows.state.keys[:, lane],
                          cpu.flows.state.keys[:, lane]))
        for lane, f in enumerate(("packets", "bytes")):
            pairs.append((f"flows.{f}", gpu.flows.state.counters[:, lane],
                          cpu.flows.state.counters[:, lane]))
    if gpu.provenance_enabled:
        pairs += [(f"provenance.{f}", getattr(gpu.last_provenance, f),
                   getattr(cpu.last_provenance, f))
                  for f in ("match_slot", "tier")]
    return {name: int((g.cpu() != c).sum()) for name, g, c in pairs}


def serve_parity(label, dev, load, step, streams, family6: bool,
                 flows: bool) -> dict:
    """The port on the card and on the CPU, from one seed and one state
    (``load(dp)``), provenance on, the flow table on with ``flows``: 2
    batches at B = 2**20 from ``streams[0]``, then 8 at B = 2**16 from
    ``streams[1]`` after a 60 s pause (so SYN-only and closed entries
    have expired), with a CT snapshot after the 5th batch, a GC after
    the 6th and, after the 8th, a restore of that snapshot into both.
    ``step(dp, batch, now)`` serves one batch.  Raises on any
    mismatch."""
    pair = []
    for where in (dev, torch.device("cpu")):
        dp = engine.Datapath(ct_slots=V4_CT_SLOTS, ct_probe=V4_CT_PROBE,
                             device=where)
        load(dp)
        dp.enable_provenance()
        if flows:
            enable_flows(dp)
        pair.append(dp)
    gpu, cpu = pair
    total = {}
    snapshot = None
    fam = 1 if family6 else 0
    for k in range(10):
        b = V4_BATCH if k < 2 else V4_SMALL
        now = V4_T0 + k if k < 2 else V4_T0 + 60 + k
        host = torch.as_tensor(next(streams[0] if k < 2 else streams[1]))
        claiming = flows and gpu._flow_tick % FLOW_CLAIM_EVERY == 0
        outs_g = step(gpu, host.to(dev), now)
        outs_c = step(cpu, host, now)
        torch.cuda.synchronize()
        extra = {}
        if k == 4:
            snapshot = gpu.snapshot_ct()
        if k == 5:
            extra["gc_deleted"] = [gpu.gc(now), cpu.gc(now)]
        if k == 7:
            extra["restored"] = [gpu.restore_ct_snapshots(*snapshot),
                                 cpu.restore_ct_snapshots(*snapshot)]
        mism = mismatches(outs_g, outs_c, gpu, cpu, family6)
        for name, (g, c) in extra.items():
            mism[name] = int(g != c)
        for name, bad in mism.items():
            total[name] = total.get(name, 0) + bad
        if flows:
            extra["flows"] = gpu.flow_stats()
            extra["claiming"] = claiming
        emit(f"{label}-parity", batch_index=k, b=b, now=now,
             flows_on=flows, mismatches=sum(mism.values()),
             ct_entries=gpu.ct_entries()[fam], **extra,
             nonzero={n: v for n, v in mism.items() if v})
        if any(mism.values()):
            raise AssertionError(f"{label} step: card != CPU at batch {k}: "
                                 f"{ {n: v for n, v in mism.items() if v} }")
    return {"batches": 10, "flows_on": flows, "mismatches": total}


# CUDA runtime calls that make the host wait for the device, or copy
# between host and device: none may run inside a step
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync",
              "cudaMemcpy2D", "cudaMemcpy2DAsync")


def behind_sleep(run, batch) -> dict:
    """One ``run.step`` behind a ``torch.cuda._sleep`` that holds the
    stream for about half a second, traced by ``torch.profiler``: the
    host time of the call and the CUDA runtime calls made inside it.  A
    host read would show as a synchronise or copy call that lasts until
    the sleep ends; a step of more kernels than the launch queue holds
    blocks instead in a kernel launch, which reads nothing."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        with record_function("serving-step"):
            run.step(batch)
        host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    evs = prof.events()
    span = [e for e in evs if e.name == "serving-step"][0].time_range
    runtime = [e for e in evs if e.device_type == DeviceType.CPU
               and e.name.startswith("cuda")
               and span.start <= e.time_range.start <= span.end]
    counts: dict = {}
    for e in runtime:
        counts[e.name] = counts.get(e.name, 0) + 1
    longest = max(runtime, key=lambda e: e.time_range.elapsed_us(),
                  default=None)
    return {"host_ms": host_ms,
            "host_waits": {n: c for n, c in counts.items()
                           if n in HOST_WAITS},
            "launches": counts.get("cudaLaunchKernel", 0),
            "longest_call": None if longest is None else longest.name,
            "longest_call_ms": 0.0 if longest is None
            else longest.time_range.elapsed_us() / 1e3}


def sync_check(run, calls: int) -> dict:
    """No host read inside ``run.step``, shown two ways on batches
    already on the card, provenance on and off in turn; with the flow
    table on, ``calls`` >= the claim stripe puts a claiming and a
    claim-free call in each half:

    - under ``set_sync_debug_mode("error")`` every synchronising call
      PyTorch detects raises;
    - behind a ``torch.cuda._sleep`` (``behind_sleep``) the call must
      return on the host before the sleep ends, or, where the step has
      more kernels than the launch queue holds, the profiler must show
      that it made no synchronising or copying runtime call and that
      what held the host was a kernel launch."""
    batches = [torch.as_tensor(run.next_batch(), device=run.device)
               for _ in range(2 * calls)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    end.record()
    end.synchronize()
    sleep_ms = start.elapsed_time(end)
    dp = run.dp
    claiming = []
    probes = []
    for i in range(2 * calls):
        (dp.enable_provenance if i % 2 == 0 else dp.disable_provenance)()
        if dp.flows is not None:
            claiming.append(dp._flow_tick % FLOW_CLAIM_EVERY == 0)
        if i < calls:
            torch.cuda.set_sync_debug_mode("error")
            try:
                run.step(batches[i])
            finally:
                torch.cuda.set_sync_debug_mode(0)
        else:
            probe = behind_sleep(run, batches[i])
            probe["returned_before_sleep_ended"] = \
                probe["host_ms"] < sleep_ms
            probe["held_by_launch_queue"] = \
                not probe["host_waits"] and probe["launches"] > 0 and \
                probe["longest_call"] == "cudaLaunchKernel"
            probes.append(probe)
        torch.cuda.synchronize()
        run.advance()
    dp.enable_provenance()
    bad = [p for p in probes if p["host_waits"] or not (
        p["returned_before_sleep_ended"] or p["held_by_launch_queue"])]
    if bad:
        raise AssertionError(f"the step may read the card: {bad} behind a "
                             f"{sleep_ms} ms sleep")
    if dp.flows is not None and not (any(claiming[:calls]) and
                                     any(claiming[calls:])):
        raise AssertionError(f"no claiming call in a half: {claiming}")
    return {"calls": 2 * calls, "sync_debug_mode": "error",
            "raised": False, "flows_on": dp.flows is not None,
            "claiming": claiming, "sleep_ms": sleep_ms,
            "host_ms_behind_sleep": [p["host_ms"] for p in probes],
            "behind_sleep": probes}


class _ReadsBack:
    """``run`` whose step also reads a verdict back on the host: the
    control that ``behind_sleep`` must flag."""

    def __init__(self, run):
        self.run = run

    def step(self, batch):
        out = self.run.step(batch)
        return int(out[0][0])


def sleep_control(run) -> dict:
    """``behind_sleep`` on a step followed by a host read of one
    verdict: it must report the read (so its silence on the real steps
    means something on this machine)."""
    batch = torch.as_tensor(run.next_batch(), device=run.device)
    probe = behind_sleep(_ReadsBack(run), batch)
    run.advance()
    if not probe["host_waits"]:
        raise AssertionError(f"the sleep probe missed a host read: {probe}")
    return probe


def serve_timed(run, calls: int, entry: str) -> dict:
    """Per-batch device time of ``calls`` fresh batches, CUDA events
    around the host-to-device copy and the step (clock, GC and the
    next batch's generation outside): ``process_packed`` and
    ``process6`` copy their batch matrix once from a pinned staging
    buffer; ``process`` makes its batch with ``make_full_batch`` (ten
    copies).  Also the shares of verdicts and events over the timed
    batches."""
    stage = None
    ms, event_counts, verdict_counts = [], {}, {}
    for _ in range(calls):
        host = run.next_batch()
        if stage is None:
            stage = torch.empty(host.shape, dtype=torch.int32).pin_memory()
        stage.copy_(torch.from_numpy(host))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if entry == "process":
            cols = {f: host[i] for i, f in enumerate(PACKED_FIELDS)}
            out = run.dp.process(engine.make_full_batch(
                **cols, device=run.device), now=run.now)
        else:
            out = run.step(stage.to(run.device, non_blocking=True))
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        verdict, event = out[0], out[1]
        for name, mask in (("drop", verdict < 0), ("allow", verdict == 0),
                           ("proxy", verdict > 0)):
            verdict_counts[name] = verdict_counts.get(name, 0) + \
                int(mask.sum())
        codes, counts = torch.unique(event, return_counts=True)
        for c, n in zip(codes.tolist(), counts.tolist()):
            key = events.event_name(c)
            event_counts[key] = event_counts.get(key, 0) + n
        run.advance()
    n_pk = sum(verdict_counts.values())
    return {"entry": entry, "flows_on": run.dp.flows is not None,
            "batch": run.batch, "samples": len(ms),
            "median_batch_ms": float(np.median(ms)),
            "p99_batch_ms": float(np.percentile(ms, 99)),
            "max_batch_ms": float(max(ms)),
            "verdicts_per_s": run.batch / (float(np.median(ms)) / 1e3),
            "verdict_share": {k: v / n_pk
                              for k, v in verdict_counts.items()},
            "event_share": {k: v / n_pk for k, v in event_counts.items()},
            "name_power_limit": nvidia_smi("name,power.limit")}


def warm_up(run, batches: int) -> int:
    """Serve ``batches`` batches; returns the CT entries GC deleted."""
    deleted = 0
    for _ in range(batches):
        run.step(torch.as_tensor(run.next_batch(), device=run.device))
        deleted += run.advance()
    torch.cuda.synchronize()
    return deleted


def flows_leg(run, label: str) -> dict:
    """Turn the daemon's flow table on, serve ``FLOW_WARMUP`` batches,
    and report its occupancy and lost share."""
    enable_flows(run.dp)
    t0 = time.perf_counter()
    warm_up(run, FLOW_WARMUP)
    stats = run.dp.flow_stats()
    res = {"batches": FLOW_WARMUP, **stats,
           "occupancy": stats["occupied"] / stats["slots"],
           "lost_share": stats["lost"] / max(1, stats["updates"]),
           "seconds": time.perf_counter() - t0}
    emit(f"{label}-flows", **res)
    return res


def tensor_bytes(obj) -> int:
    """Bytes of every tensor in a (nested) NamedTuple of tensors."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, tuple):
        return sum(tensor_bytes(x) for x in obj)
    return 0


def check_shares(label, shares, names) -> None:
    for name in names:
        if not shares.get(name):
            raise AssertionError(f"{label} step: no packet took {name!r}")


def phase_v4(dev):
    """The v4 phase; returns (the dense kernel's launches during it, the
    state).  The path runs no hand-written kernel."""
    t0 = time.perf_counter()
    state = v4_serving_state(**V4_STATE)
    emit("v4-state", endpoints=len(state.ep_identity),
         policy_entries=sum(len(s) for s in state.states),
         ipcache_prefixes=len(state.prefixes),
         services=len(state.services),
         backends=sum(len(s.backends) for s in state.services),
         backendless_last=len(state.services[-1].backends) == 0,
         prefilter_cidrs=len(state.prefilter),
         peer_nodes=len(state.tunnel), ct_slots=V4_CT_SLOTS,
         ct_probe=V4_CT_PROBE, setup_s=time.perf_counter() - t0)

    dv.dense_verdict.launches = 0
    for flows in (False, True):
        t0 = time.perf_counter()
        parity = serve_parity(
            "v4", dev, state.load,
            lambda dp, x, now: dp.process_packed(x, now=now),
            (v4_serving_packets(state, V4_BATCH, n_flows=V4_FLOWS, seed=5),
             v4_serving_packets(state, V4_SMALL, n_flows=V4_FLOWS // 16,
                                seed=6)), family6=False, flows=flows)
        emit("v4-parity-total", seconds=time.perf_counter() - t0, **parity)

    run = V4Run(V4_BATCH, dev, ct_slots=V4_CT_SLOTS, ct_probe=V4_CT_PROBE,
                state=state, n_flows=V4_FLOWS)
    t0 = time.perf_counter()
    deleted = warm_up(run, V4_WARMUP)
    emit("v4-warmup", batches=V4_WARMUP, gc_deleted=deleted,
         ct_entries=run.dp.ct_entries()[0],
         ct_occupancy=run.dp.ct_entries()[0] / V4_CT_SLOTS,
         seconds=time.perf_counter() - t0)
    emit("v4-sync", **sync_check(run, 2))
    emit("v4-sync-control", **sleep_control(run))
    timed = [serve_timed(run, V4_TIMED["process_packed"], "process_packed"),
             serve_timed(run, V4_TIMED["process"], "process")]
    for res in timed:
        emit("v4-timing", **res)
    occupancy = run.dp.ct_entries()[0] / V4_CT_SLOTS
    prof = profile_run(run, 5)
    emit("v4-profile", batch=V4_BATCH, flows_on=False, **prof)

    flows = flows_leg(run, "v4")
    emit("v4-sync", **sync_check(run, FLOW_CLAIM_EVERY))
    timed_f = serve_timed(run, V4_TIMED["flows"], "process_packed")
    emit("v4-timing", **timed_f)
    prof_f = profile_run(run, 4)
    emit("v4-profile", batch=V4_BATCH, flows_on=True, **prof_f,
         flows_busy_ms=prof_f["busy_ms"] - prof["busy_ms"])
    launches = dv.dense_verdict.launches
    check_shares("v4", timed[0]["event_share"],
                 ("to-endpoint", "to-overlay", "Policy denied (L3/L4)",
                  "Prefilter denied"))
    emit("v4", ct_occupancy=occupancy,
         hand_kernel_launches={"dense_verdict": launches},
         median_batch_ms=timed[0]["median_batch_ms"],
         p99_batch_ms=timed[0]["p99_batch_ms"],
         verdicts_per_s=timed[0]["verdicts_per_s"],
         flows_median_batch_ms=timed_f["median_batch_ms"],
         flows_verdicts_per_s=timed_f["verdicts_per_s"],
         flow_occupancy=flows["occupancy"],
         flow_lost_share=flows["lost_share"])
    return launches, state


def phase_v6(dev, state4) -> int:
    """The v6 phase: ``Datapath.process6`` over the v6 twin of the v4
    state; returns the dense kernel's launches during it."""
    t0 = time.perf_counter()
    state = v6_of(state4)
    embed_s = time.perf_counter() - t0

    dv.dense_verdict.launches = 0
    t0 = time.perf_counter()
    parity = serve_parity(
        "v6", dev, state.load,
        lambda dp, x, now: dp.process6(unpack6(x), now=now),
        (v6_serving_packets(state, V4_BATCH, n_flows=V4_FLOWS, seed=5),
         v6_serving_packets(state, V4_SMALL, n_flows=V4_FLOWS // 16,
                            seed=6)), family6=True, flows=True)
    emit("v6-parity-total", seconds=time.perf_counter() - t0, **parity)

    t0 = time.perf_counter()
    run = V6Run(V4_BATCH, dev, ct_slots=V4_CT_SLOTS, ct_probe=V4_CT_PROBE,
                state=state, n_flows=V4_FLOWS)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    dp = run.dp
    t6 = dp._tables6
    emit("v6-state", endpoints=len(state4.ep_identity),
         policy_entries=sum(len(s) for s in state4.states),
         ipcache6_prefixes=len(state.prefixes6),
         ipcache6_lengths=int(t6.ipcache6.kb.shape[0]),
         ipcache6_slots=int(t6.ipcache6.kb.shape[1]),
         ipcache6_probe=dp._statics6["lpm6_probe"],
         services6=len(state.services6),
         backends6=sum(len(s.backends) for s in state.services6),
         backendless_last=len(state.services6[-1].backends) == 0,
         lb6_slots=int(t6.lb6.svc_kb.shape[0]),
         lb6_probe=dp._statics6["lb6_probe"],
         prefilter6_cidrs=len(state.prefilter6),
         prefilter6_lengths=int(t6.pf6.kb.shape[0]),
         router6=state.router6, ct6_slots=V4_CT_SLOTS,
         ct6_probe=V4_CT_PROBE,
         table_bytes={"v6_tables": tensor_bytes(t6),
                      "ct6": tensor_bytes(dp.ct6.state),
                      "counters": tensor_bytes(dp._counters)},
         embed_s=embed_s, load_s=load_s)

    t0 = time.perf_counter()
    deleted = warm_up(run, V4_WARMUP)
    emit("v6-warmup", batches=V4_WARMUP, gc_deleted=deleted,
         ct6_entries=dp.ct_entries()[1],
         ct6_occupancy=dp.ct_entries()[1] / V4_CT_SLOTS,
         seconds=time.perf_counter() - t0)
    emit("v6-sync", **sync_check(run, 2))
    timed = serve_timed(run, V6_TIMED["off"], "process6")
    emit("v6-timing", **timed)
    prof = profile_run(run, 5)
    emit("v6-profile", batch=V4_BATCH, flows_on=False, **prof)

    flows = flows_leg(run, "v6")
    emit("v6-sync", **sync_check(run, FLOW_CLAIM_EVERY))
    timed_f = serve_timed(run, V6_TIMED["flows"], "process6")
    emit("v6-timing", **timed_f)
    prof_f = profile_run(run, 4)
    emit("v6-profile", batch=V4_BATCH, flows_on=True, **prof_f,
         flows_busy_ms=prof_f["busy_ms"] - prof["busy_ms"])
    launches = dv.dense_verdict.launches
    check_shares("v6", timed["event_share"],
                 ("to-endpoint", "Policy denied (L3/L4)",
                  "Prefilter denied", "icmp6-ns-reply", "icmp6-echo-reply",
                  "Unknown ICMPv6 ND target"))
    emit("v6", ct6_occupancy=dp.ct_entries()[1] / V4_CT_SLOTS,
         hand_kernel_launches={"dense_verdict": launches},
         median_batch_ms=timed["median_batch_ms"],
         p99_batch_ms=timed["p99_batch_ms"],
         verdicts_per_s=timed["verdicts_per_s"],
         flows_median_batch_ms=timed_f["median_batch_ms"],
         flows_p99_batch_ms=timed_f["p99_batch_ms"],
         flows_verdicts_per_s=timed_f["verdicts_per_s"],
         flow_occupancy=flows["occupancy"],
         flow_lost_share=flows["lost_share"])
    return launches


# ---------------------------------------------------------------------------
# phase 7: BASELINE config 2 on the bucket engine
# ---------------------------------------------------------------------------

CONFIG2_STATE = {}      # build_config2() arguments: the full BASELINE width
CONFIG2_BATCH = 1 << 20
CONFIG2_PARITY_BATCHES = 3
CONFIG2_TIMED = 60
MIXED_STATE = (256, 200)  # endpoints x entries of the mixed-kind case
MIXED_BATCH = 1 << 16


class _Call:
    """A no-argument call as a ``run`` for ``behind_sleep``."""

    def __init__(self, fn):
        self.fn = fn

    def step(self, _batch):
        return self.fn()


def no_host_read(fn) -> dict:
    """``fn`` (a step on inputs already on the card) makes no host read:
    it raises nothing under ``set_sync_debug_mode("error")``, and behind
    a ``torch.cuda._sleep`` it returns on the host before the sleep ends
    with no synchronising or copying CUDA runtime call (these steps
    launch far fewer kernels than the launch queue holds)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    end.record()
    end.synchronize()
    sleep_ms = start.elapsed_time(end)
    probe = behind_sleep(_Call(fn), None)
    probe["sleep_ms"] = sleep_ms
    probe["returned_before_sleep_ended"] = probe["host_ms"] < sleep_ms
    if probe["host_waits"] or not probe["returned_before_sleep_ended"]:
        raise AssertionError(f"the step may read the card: {probe}")
    return {"sync_debug_mode": "error", "raised": False, **probe}


def timing(ms, rows: int) -> dict:
    return {"samples": len(ms), "median_batch_ms": float(np.median(ms)),
            "p99_batch_ms": float(np.percentile(ms, 99)),
            "max_batch_ms": float(max(ms)),
            "rows_per_s": rows / (float(np.median(ms)) / 1e3),
            "name_power_limit": nvidia_smi("name,power.limit")}


def bucket_mismatches(got, want, eng_g, eng_c) -> dict:
    """Differing verdicts of one step, and differing entries of both
    counter arrays, between the card's engine and the CPU's."""
    return {"verdict": int((got.cpu() != want).sum()),
            "packets": int((eng_g.counters.packets.cpu() !=
                            eng_c.counters.packets).sum()),
            "bytes": int((eng_g.counters.bytes.cpu() !=
                          eng_c.counters.bytes).sum())}


def bucket_bytes_bound_ms(run) -> float:
    """Least time for the bucket step's bytes: per packet its 7 input
    words read and its verdict written, 3 stages x 2 bucket rows x 3
    table words x W slots read, and two counter words read and
    written."""
    w = run.engine.width
    per_packet = 4 * (7 + 1 + 3 * 2 * 3 * w + 2 * 2)
    return run.batch * per_packet / HBM_BYTES_PER_S * 1e3


def phase_config2(dev) -> int:
    """BASELINE config 2 (10,000 endpoints x 1,000 exact INGRESS rules,
    10M entries) on the two-choice bucket engine at B = 2**20; returns
    the dense kernel's launches during it (the path runs none)."""
    dv.dense_verdict.launches = 0
    t0 = time.perf_counter()
    state = build_config2(**CONFIG2_STATE)
    gen_s = time.perf_counter() - t0 - state.build_s
    torch.cuda.reset_peak_memory_stats()
    run = Config2Run(CONFIG2_BATCH, dev, state=state)
    cpu = BucketVerdictEngine(state.tables, device="cpu")
    torch.cuda.synchronize()
    tables = state.tables
    emit("config2-state", endpoints=tables.num_endpoints,
         rules_per_ep=int(state.ident.shape[1]),
         entries=tables.entry_count(), buckets_per_ep=tables.buckets_per_ep,
         width=tables.width, slots=int(tables.key_a.size),
         table_mb=tables.nbytes() / 1e6,
         counters_mb=(run.engine.nbytes() - tables.nbytes()) / 1e6,
         build_s=state.build_s, generate_s=gen_s)

    # the card against the same engine on the CPU, 3 batches
    total = {}
    first = run.packets(seed=4)
    for k in range(CONFIG2_PARITY_BATCHES):
        host = first if k == 0 else run.packets(seed=4 + k)
        got = run.step(run.to_device(host))
        want = cpu(*[torch.as_tensor(host[f]) for f in CONFIG2_FIELDS])
        torch.cuda.synchronize()
        mism = bucket_mismatches(got, want, run.engine, cpu)
        for name, bad in mism.items():
            total[name] = total.get(name, 0) + bad
        emit("config2-parity", batch_index=k, b=CONFIG2_BATCH,
             mismatches=mism, allowed=int((want == 0).sum()),
             dropped=int((want == VERDICT_DROP).sum()))
        if any(mism.values()):
            raise AssertionError(f"config2: card != CPU at batch {k}: {mism}")
    counted = int(run.engine.counters.packets.sum(dtype=torch.int64))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the flat-array oracle on a sample of the first batch
    verdict = run.step(run.to_device(first)).cpu().numpy()
    idx = np.linspace(0, CONFIG2_BATCH - 1, ORACLE_SAMPLE).astype(int)
    bad = [int(i) for i in idx if verdict[i] != state.oracle_verdict(
        *(int(first[f][i]) for f in ("endpoint", "identity", "dport",
                                     "proto", "direction", "is_fragment")))]
    if bad:
        raise AssertionError(f"config2: {len(bad)} oracle mismatches, "
                             f"first at packet {bad[0]}")

    mixed = phase_config2_mixed(dev)

    pkts = run.to_device(run.packets(seed=9))
    sync = no_host_read(lambda: run.step(pkts))
    ms = cuda_ms(lambda: run.step(pkts), CONFIG2_TIMED)
    prof = profile_step(lambda: run.step(pkts), 5)
    res = {"batch": CONFIG2_BATCH, **timing(ms, CONFIG2_BATCH),
           "peak_gb": peak_gb, "counted_packets": counted,
           "oracle_sample": len(idx), "oracle_mismatches": 0,
           "parity_mismatches": total,
           "bytes_bound_ms": bucket_bytes_bound_ms(run)}
    emit("config2-sync", **sync)
    emit("config2-profile", batch=CONFIG2_BATCH, **prof)
    launches = dv.dense_verdict.launches
    emit("config2", **res, mixed=mixed,
         hand_kernel_launches={"dense_verdict": launches})
    return launches


def phase_config2_mixed(dev) -> dict:
    """Exact, L3-only and L4-wildcard entries with proxy ports, both
    directions, 10% fragments and byte counters that wrap: the stages
    the config-2 traffic never reaches.  Card against CPU over 3
    batches, and the map-state oracle on a sample."""
    states = mixed_bucket_states(*MIXED_STATE, seed=11)
    tables = compile_states_bucketed(states, revision=1)
    gpu = BucketVerdictEngine(tables, device=dev)
    cpu = BucketVerdictEngine(tables, device="cpu")
    total, verdicts = {}, {}
    for k in range(3):
        host = mixed_bucket_packets(states, MIXED_BATCH, seed=30 + k)
        got = gpu(*[torch.as_tensor(host[f], device=dev)
                    for f in CONFIG2_FIELDS])
        want = cpu(*[torch.as_tensor(host[f]) for f in CONFIG2_FIELDS])
        torch.cuda.synchronize()
        mism = bucket_mismatches(got, want, gpu, cpu)
        for name, bad in mism.items():
            total[name] = total.get(name, 0) + bad
        if any(mism.values()):
            raise AssertionError(f"config2 mixed: card != CPU at {k}: {mism}")
        codes, counts = torch.unique(want, return_counts=True)
        for c, n in zip(codes.tolist(), counts.tolist()):
            verdicts[str(c)] = verdicts.get(str(c), 0) + n
        for i in range(0, MIXED_BATCH, MIXED_BATCH // 512):
            if host["is_fragment"][i]:
                continue
            want_i = oracle_verdict(
                states[host["endpoint"][i]], int(host["identity"][i]),
                int(host["dport"][i]), int(host["proto"][i]),
                int(host["direction"][i]))
            if int(want[i]) != want_i:
                raise AssertionError(f"config2 mixed: oracle at {k}/{i}")
    for code in ("-2", "-1", "0", "15001"):
        if not verdicts.get(code):
            raise AssertionError(f"config2 mixed: no verdict {code}")
    return {"endpoints": MIXED_STATE[0], "entries": tables.entry_count(),
            "batches": 3, "b": MIXED_BATCH, "mismatches": total,
            "verdicts": verdicts}


# ---------------------------------------------------------------------------
# phase 8: BASELINE configs 3-5, the L7 engines
# ---------------------------------------------------------------------------

L7_BATCHES = (32768, 1 << 20)   # the bench's batch, and 2**20 rows
L7_TIMED = 50
L7_SMALL = 4096                 # the header, long-payload and sweep cases
HEADER_RULES = (PortRuleHTTP(method="GET", path="/api/.*",
                             headers=("X-Token abc.1",)),
                PortRuleHTTP(method="POST", path="/upload",
                             headers=("Content-Type", "x-req-id 7")),
                PortRuleHTTP(method="DELETE"))


def _l7_rows(name, gpu, cpu, sample_oracle, encode, match, batch) -> dict:
    """One L7 engine on the card against its twin on the CPU (built with
    the card's selection) over every row, the Python ``re`` oracle on a
    sample, the host encode time, then ``match`` on pre-encoded blocks
    already on the card: no host read, CUDA-event timing, profile."""
    if gpu.engine_report() != cpu.engine_report():
        raise AssertionError(f"{name}: CPU twin selects otherwise")
    t0 = time.perf_counter()
    enc = encode(gpu)
    encode_s = time.perf_counter() - t0
    got = match(gpu, enc).cpu()
    want = match(cpu, enc)
    mism = int((got != want).sum())
    if mism:
        raise AssertionError(f"{name} at {batch}: {mism} card != CPU rows")
    oracle_bad = sample_oracle(got.numpy())
    if oracle_bad:
        raise AssertionError(f"{name} at {batch}: {oracle_bad} oracle "
                             "mismatches")
    on_card = tuple(None if e is None else e.to(gpu.device) for e in enc)
    sync = no_host_read(lambda: match(gpu, on_card))
    ms = cuda_ms(lambda: match(gpu, on_card), L7_TIMED)
    prof = profile_step(lambda: match(gpu, on_card), 5)
    res = {"engine": name, "batch": batch, "rows": int(got.shape[0]),
           "allowed": int(got.reshape(got.shape[0], -1).any(1).sum()),
           "mismatches": mism, "oracle_mismatches": 0,
           "encode_packed_s": encode_s,
           "encode_rows_per_s": batch / encode_s,
           **timing(ms, batch), "describe": gpu.engine_report()}
    emit("l7-sync", engine=name, batch=batch, **sync)
    emit("l7-profile", engine=name, batch=batch, **prof)
    emit("l7", **res)
    return res


def _http_oracle(reqs, patterns):
    def check(got) -> int:
        idx = np.linspace(0, len(reqs) - 1, ORACLE_SAMPLE).astype(int)
        return sum(bool(got[i]) != any(
            oracle_match(p, http_request_line(reqs[i]).encode())
            for p in patterns) for i in idx)
    return check


def _dns_oracle(names, selectors):
    def check(got) -> int:
        idx = np.linspace(0, len(names) - 1, ORACLE_SAMPLE).astype(int)
        return sum(bool(got[i].any()) != any(
            oracle_match(s.to_regex(), names[i].lower().rstrip(".")
                         .encode()) for s in selectors) for i in idx)
    return check


def _http_case(name, rules, reqs, batch_hint, dev) -> dict:
    """An HTTP rule set on the card against the CPU twin, whole batch."""
    gpu = HTTPPolicyEngine(rules, batch_hint=batch_hint, device=dev)
    cpu = HTTPPolicyEngine(rules, batch_hint=batch_hint, device="cpu",
                           on_accel=gpu.device.type == "cuda")
    if gpu.engine_report() != cpu.engine_report():
        raise AssertionError(f"{name}: CPU twin selects otherwise")
    got, want = gpu.check(reqs), cpu.check(reqs)
    mism = int((got != want).sum())
    if mism or not 0 < want.sum() < len(reqs):
        raise AssertionError(f"{name}: {mism} mismatches, "
                             f"{int(want.sum())} allowed")
    return {"case": name, "rows": len(reqs), "mismatches": mism,
            "allowed": int(want.sum()), "describe": gpu.engine_report()}


def _strategy_sweep(dev) -> list:
    """Every strategy x dtype of ``DFAEngine`` over the config-3 table on
    the card, against the same engine on the CPU."""
    compiled = compile_regex_set([rule_to_combined_regex(r)
                                  for r in HTTP_RULES])
    data = HTTPPolicyEngine(list(HTTP_RULES), device="cpu").encode(
        config3_requests(L7_SMALL))[0]
    out = []
    for prefer in ("stride", "compose", "assoc"):
        for dtype in (np.int8, np.int16, np.int32):
            kw = dict(max_len=512, prefer=prefer, dtype=dtype,
                      stride_budget=200_000)
            gpu = DFAEngine(compiled, device=dev, **kw)
            cpu = DFAEngine(compiled, device="cpu", **kw)
            want = cpu.match(data)
            mism = int((gpu.match(data).cpu() != want).sum()) + int(
                (gpu.match_encoded(gpu.encode(data).to(dev)).cpu() !=
                 want).sum())
            if mism:
                raise AssertionError(f"DFAEngine {prefer}/{dtype}: {mism}")
            out.append({"tag": gpu.describe()["tag"], "mismatches": mism})
    return out


def phase_l7(dev) -> int:
    """BASELINE configs 3-5 (``bench_suite.py``'s http-regex, kafka-acl
    and fqdn shapes); returns the dense kernel's launches during it."""
    dv.dense_verdict.launches = 0
    card = dev.type == "cuda"   # each CPU twin takes the card's selection
    results = []
    for batch in L7_BATCHES:
        reqs = config3_requests(batch)
        gpu = HTTPPolicyEngine(list(HTTP_RULES), batch_hint=batch,
                               device=dev)
        cpu = HTTPPolicyEngine(list(HTTP_RULES), batch_hint=batch,
                               device="cpu", on_accel=card)
        patterns = [rule_to_combined_regex(r) for r in HTTP_RULES]
        results.append(_l7_rows(
            "http", gpu, cpu, _http_oracle(reqs, patterns),
            lambda e: e.encode_packed(reqs),
            lambda e, enc: e.match_device(*enc)[:batch], batch))

        names = config5_names(batch)
        gpu = DNSPolicyEngine(list(FQDN_SELECTORS), batch_hint=batch,
                              device=dev)
        cpu = DNSPolicyEngine(list(FQDN_SELECTORS), batch_hint=batch,
                              device="cpu", on_accel=card)
        results.append(_l7_rows(
            "fqdn", gpu, cpu, _dns_oracle(names, FQDN_SELECTORS),
            lambda e: (e.encode_packed(names),),
            lambda e, enc: e.match_device(enc[0])[:batch], batch))

    # the card's own choice where it differs from the bench's: header
    # rules and long payloads select assoc at the default batch hint
    rng = np.random.default_rng(12)
    hdrs = [None, {"X-Token": "abc.1"}, {"Content-Type": "json",
                                         "X-Req-Id": "7"},
            {"x-token": "abc.2"}, {"content-type": "json"}]
    header_reqs = [HTTPRequest(
        method=("GET", "POST", "DELETE", "PUT")[i % 4],
        path=("/api/v1", "/upload", "/x")[i % 3],
        headers=hdrs[rng.integers(0, len(hdrs))]) for i in range(L7_SMALL)]
    long_reqs = [HTTPRequest(method="GET", path="/public/" + "p" * int(n),
                             host="admin.example.com")
                 for n in rng.integers(200, 520, L7_SMALL)]
    cases = [_http_case("http-headers", list(HEADER_RULES), header_reqs,
                        2048, dev),
             _http_case("http-long-payload", list(HTTP_RULES), long_reqs,
                        2048, dev)]
    strategies = {c["describe"][part]["strategy"] for c in cases
                  for part in c["describe"]}
    if card and "assoc" not in strategies:
        raise AssertionError(f"no assoc case on the card: {strategies}")
    for case in cases:
        emit("l7-case", **case)
    sweep = _strategy_sweep(dev)
    emit("l7-sweep", engines=sweep)

    # config 4: Kafka ACLs run on the host only
    kafka = KafkaPolicyEngine(list(KAFKA_RULES))
    kreqs = config4_requests(8192)
    kafka.check(kreqs)
    t0 = time.perf_counter()
    for _ in range(10):
        verdicts = kafka.check(kreqs)
    kafka_s = (time.perf_counter() - t0) / 10
    emit("l7-kafka", device="host (no device work)", batch=len(kreqs),
         allowed=sum(verdicts), batch_s=kafka_s,
         requests_per_s=len(kreqs) / kafka_s)
    launches = dv.dense_verdict.launches
    emit("l7-summary", hand_kernel_launches={"dense_verdict": launches},
         **{f"{r['engine']}_{r['batch']}_median_ms": r["median_batch_ms"]
            for r in results})
    return launches


# ---------------------------------------------------------------------------
# phase 9: the fused optional stages (L7 fast verdict, threat, analytics)
# ---------------------------------------------------------------------------

STAGE_BATCH = 1 << 20
STAGE_SMALL = 1 << 16
STAGE_PARITY_BATCHES = 3
STAGE_TIMED = 50
STAGE_CYCLE = 5       # distinct 2**20 batches the timed legs cycle through
STAGE_PROFILE = 3
# stage legs per family, in this order ("all" is v4 only)
STAGE_LEGS = ("off", "l7fast", "threat-shadow", "threat", "analytics",
              "all")


class StageRun:
    """A full-width ``Datapath`` serving a fixed set of batches already on
    the card in turn, each with its own payload lane, behind the
    interface of ``V4Run`` / ``V6Run`` (``step``, ``next_batch``,
    ``advance``, ``now``) that ``sync_check`` and ``profile_run`` use."""

    def __init__(self, dp, family6: bool, batches, payloads):
        self.dp = dp
        # the empty tables, restored before each leg (``reset``)
        self._empty_ct = dp.snapshot_ct()
        self.family6 = family6
        self.device = dp.device
        self.batch = int(batches[0].shape[1])
        self.batches = batches
        self._payload_of = {b.data_ptr(): p
                            for b, p in zip(batches, payloads)}
        self.i = 0
        self.t = 0

    @property
    def now(self) -> int:
        return V4_T0 + 1000 + self.t

    def next_batch(self):
        b = self.batches[self.i % len(self.batches)]
        self.i += 1
        return b

    def step(self, batch):
        pl = self._payload_of[batch.data_ptr()]
        if self.family6:
            return self.dp.process6(unpack6(batch), now=self.now,
                                    payload=pl)
        return self.dp.process_packed(batch, now=self.now, payload=pl)

    def advance(self) -> int:
        self.t += 1
        return self.dp.gc(self.now) if self.t % 8 == 0 else 0

    def reset(self) -> None:
        """Empty conntrack and flow tables, and the first batch next:
        every leg starts from the same state."""
        self.dp.restore_ct_snapshots(*self._empty_ct)
        if self.dp.flows is not None:
            self.dp.flows.reset()
            self.dp._flow_tick = 0
        self.i = 0


def set_stages(dp, leg: str, l7st) -> None:
    """Put ``dp``'s optional stages in the state of one leg."""
    want = {"l7fast": leg in ("l7fast", "all"),
            "threat": leg in ("threat-shadow", "threat", "all"),
            "analytics": leg in ("analytics", "all")}
    if want["l7fast"]:
        if dp._l7_fast is None:
            dp.enable_l7_fast(l7st.programs)
    else:
        dp.disable_l7_fast()
    if want["threat"]:
        cfg = ThreatConfig() if leg == "threat-shadow" \
            else threat_enforce_config(redirect=True)
        if dp._threat is None:
            dp.enable_threat(default_model(cfg), **THREAT)
        else:
            dp.set_threat_config(cfg)
    else:
        dp.disable_threat()
    if want["analytics"]:
        if dp.analytics_state is None:
            dp.enable_analytics(**ANALYTICS)
    else:
        dp.disable_analytics()


def _flow_index(flows) -> dict:
    """The flow table as the threat oracle's index (``FlowTable.snapshot``
    rows keyed as ``threat/oracle.flow_snapshot_index`` keys them)."""
    keys = flows.keys.cpu().numpy()
    cnt = flows.counters.cpu().numpy().view(np.uint32)
    slots = keys.shape[0] - 2
    idx = np.flatnonzero(keys[:slots, 2])
    return {(int(keys[i, 0]), int(keys[i, 1]),
             int((keys[i, 2] >> 16) & 0xFFFF), int((keys[i, 2] >> 8) & 0xFF),
             int(keys[i, 2] & 0xFF) - EVENT_BIAS):
            (int(cnt[i, 0]), int(cnt[i, 1]), int(keys[i, 3]))
            for i in idx.tolist()}


def _host(x):
    return x.cpu().numpy().copy() if isinstance(x, torch.Tensor) else x


class StageTap:
    """Within the block, record every call of one stage function on the
    card: its inputs copied to the host before the call, and its state
    buffer after it, for the numpy oracles.  (The copies read the card:
    the tap runs only in the parity legs, never in a timed or checked
    step.)"""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.calls = []

    def __enter__(self):
        orig = getattr(self.module, self.name)
        self.orig = orig

        def tapped(*args, **kw):
            rec = {"args": [_host(a) for a in args],
                   "kw": {k: _host(v) for k, v in kw.items()}}
            if self.name == "threat_stage":
                tables, threat, flows = args[:3]
                rec["model"] = convert.threat_model_from_tables(
                    {n: _host(getattr(tables, n)) for n in
                     ("tm_w1", "tm_b1", "tm_w2", "tm_b2", "tm_cfg")})
                rec["pre"] = _host(threat.state)
                rec["flows"] = None if flows is None or \
                    not kw.get("flow_slots") else _flow_index(flows)
            else:
                rec["pre"] = _host(args[0].state)
            out = orig(*args, **kw)
            rec["out"] = out
            self.calls.append(rec)
            return out
        setattr(self.module, self.name, tapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def threat_oracle(tap: StageTap) -> int:
    """Elements where the card's threat stage differs from the port's
    numpy ``oracle_threat_step`` on the same inputs: verdict, threat_out
    and the whole state buffer after the call."""
    bad = 0
    for rec in tap.calls:
        kw = dict(rec["kw"])
        now = int(kw.pop("now"))
        slots = kw.pop("flow_slots")
        kw.pop("flow_probe")
        window_s, stripe = kw.pop("window_s"), kw.pop("stripe")
        state = rec["pre"].copy()
        want = oracle_threat_step(
            state, rec["model"], rec["args"][3], **kw, now=now,
            window_s=window_s, stripe=stripe,
            flow_index=rec["flows"] if slots else None)
        out = rec["out"]
        bad += int((want[0] != _host(out[0])).sum())
        bad += int((want[1] != _host(out[2])).sum())
        bad += int((state != _host(out[1].state)).sum())
    return bad


def analytics_oracle(tap: StageTap) -> int:
    """Elements of the whole analytics buffer where the card differs from
    the port's numpy ``oracle_analytics_step`` on the same inputs."""
    bad = 0
    for rec in tap.calls:
        kw = dict(rec["kw"])
        now = int(kw.pop("now"))
        state = rec["pre"].copy()
        oracle_analytics_step(state, **kw, now=now)
        bad += int((state != _host(rec["out"].state)).sum())
    return bad


def l7_engine_verdicts(l7st) -> np.ndarray:
    """Per row of the payload table: the port's HTTP or DNS policy
    engine's verdict on its string (absent and overlong rows: -1)."""
    http = HTTPPolicyEngine(list(HTTP_RULES), device="cpu")
    dns = DNSPolicyEngine(list(FQDN_SELECTORS), device="cpu")
    out = np.full(len(l7st.strings), -1, np.int64)
    for k, s in enumerate(l7st.strings[:l7st.overlong_row]):
        if k < l7st.n_http:
            m, p, h = s.split("\x00")
            out[k] = int(http.check([HTTPRequest(method=m, path=p,
                                                 host=h)])[0])
        else:
            out[k] = int(dns.allowed([s])[0])
    return out


def l7_oracle(engine_verdict, idx, tier, rng) -> dict:
    """Up to ``ORACLE_SAMPLE`` rows decided inline against the engines'
    verdicts on their strings; rows whose payload is absent or
    overlong must not be decided."""
    fa = tier == events.TIER_L7_FAST_ALLOW
    fd = tier == events.TIER_L7_FAST_DENY
    decided = np.flatnonzero(fa | fd)
    pick = rng.choice(decided, min(ORACLE_SAMPLE, decided.shape[0]),
                      replace=False) if decided.shape[0] else decided
    bad = int((engine_verdict[idx[pick]] != fa[pick]).sum())
    bad += int((engine_verdict[idx[decided]] < 0).sum())
    return {"checked": int(pick.shape[0]), "mismatches": bad}


def stage_mismatches(outs_g, outs_c, gpu, cpu, family6: bool) -> dict:
    """``mismatches`` plus threat_out, the threat and analytics buffers
    and the L7 fast-allow / fast-deny / redirect counts."""
    mism = mismatches(outs_g, outs_c, gpu, cpu, family6)
    if gpu._threat is not None:
        mism["threat_out"] = int((gpu.last_threat.cpu() !=
                                  cpu.last_threat).sum())
        mism["threat.state"] = int((gpu.threat_state.state.cpu() !=
                                    cpu.threat_state.state).sum())
    if gpu.analytics_state is not None:
        mism["analytics.state"] = int((gpu.analytics_state.state.cpu() !=
                                       cpu.analytics_state.state).sum())
    if gpu._l7_fast is not None:
        for name, n_g, n_c in zip(("allow", "deny", "redirect"),
                                  l7_counts(outs_g[0], gpu),
                                  l7_counts(outs_c[0], cpu)):
            mism[f"l7.{name}"] = abs(n_g - n_c)
    return mism


def l7_counts(verdict, dp):
    """(fast-allow, fast-deny, L7 redirect) rows of the last step."""
    tier = dp.last_provenance.tier
    return (int((tier == events.TIER_L7_FAST_ALLOW).sum()),
            int((tier == events.TIER_L7_FAST_DENY).sum()),
            int(((tier == events.TIER_L7_REDIRECT) & (verdict > 0)).sum()))


def stage_parity(fam: str, dev, load, l7st, family6: bool, stream,
                 legs) -> dict:
    """The stages on the card and on the CPU, one state and seed, flows
    and provenance on: ``STAGE_PARITY_BATCHES`` batches of 2**16 a leg,
    the legs in turn on the same engines.  Every output and buffer is
    compared (``stage_mismatches``), and the oracles run on the card's
    stage calls.  The shadow leg is also held against a third engine
    without the threat stage, which serves the legs before it with the
    same stages as the others.  Raises on any mismatch."""
    pair = []
    for where in (dev, torch.device("cpu"), torch.device("cpu")):
        dp = engine.Datapath(ct_slots=V4_CT_SLOTS, ct_probe=V4_CT_PROBE,
                             device=where)
        load(dp)
        dp.enable_provenance()
        enable_flows(dp)
        pair.append(dp)
    gpu, cpu, plain = pair
    engine_verdict = l7_engine_verdicts(l7st)
    rng = np.random.default_rng(17)
    table = torch.as_tensor(l7st.table)
    out = {}
    now = V4_T0
    shadow_at = legs.index("threat-shadow")
    for at, leg in enumerate(legs):
        set_stages(gpu, leg, l7st)
        set_stages(cpu, leg, l7st)
        if at <= shadow_at:
            set_stages(plain, "off" if leg == "threat-shadow" else leg,
                       l7st)
        total, oracle_bad, counts = {}, {}, np.zeros(3, np.int64)
        oracle_checked = 0
        for k in range(STAGE_PARITY_BATCHES):
            packed, idx = next(stream)
            host = torch.as_tensor(packed)
            payload = table[torch.as_tensor(idx).long()]
            x = host.to(dev)
            pl = payload.to(dev)
            now += 1

            def step(dp, batch, p):
                if family6:
                    return dp.process6(unpack6(batch), now=now, payload=p)
                return dp.process_packed(batch, now=now, payload=p)
            with StageTap(pipeline, "threat_stage") as t_tap, \
                    StageTap(pipeline, "analytics_stage") as a_tap:
                outs_g = step(gpu, x, pl)
                torch.cuda.synchronize()
            outs_c = step(cpu, host, payload)
            if at <= shadow_at:
                outs_p = step(plain, host, payload)
            mism = stage_mismatches(outs_g, outs_c, gpu, cpu, family6)
            if leg == "threat-shadow":
                for name, g, p in zip(("verdict", "event"), outs_g[:2],
                                      outs_p[:2]):
                    mism[f"shadow_vs_off.{name}"] = int((g.cpu() != p).sum())
                mism["shadow_vs_off.tier"] = int(
                    (gpu.last_provenance.tier.cpu() !=
                     plain.last_provenance.tier).sum())
            for name, bad in mism.items():
                total[name] = total.get(name, 0) + bad
            if t_tap.calls:
                oracle_bad["threat"] = oracle_bad.get("threat", 0) + \
                    threat_oracle(t_tap)
            if a_tap.calls:
                oracle_bad["analytics"] = oracle_bad.get("analytics", 0) \
                    + analytics_oracle(a_tap)
            if gpu._l7_fast is not None:
                tier = gpu.last_provenance.tier.cpu().numpy()
                res = l7_oracle(engine_verdict, idx, tier, rng)
                oracle_bad["l7"] = oracle_bad.get("l7", 0) + \
                    res["mismatches"]
                oracle_checked += res["checked"]
                counts += l7_counts(outs_g[0], gpu)
            if any(mism.values()) or any(oracle_bad.values()):
                raise AssertionError(
                    f"{fam} {leg} parity at batch {k}: "
                    f"{ {n: v for n, v in mism.items() if v} } "
                    f"oracle {oracle_bad}")
        res = {"leg": leg, "batches": STAGE_PARITY_BATCHES,
               "b": STAGE_SMALL, "mismatches": sum(total.values()),
               "compared": sorted(total), "oracle_mismatches": oracle_bad,
               "threat_fired": None if gpu.last_threat is None else
               int(((gpu.last_threat >> 10) & 1).sum()),
               "verdicts": {str(c): n for c, n in zip(*(
                   t.tolist() for t in torch.unique(outs_g[0].cpu(),
                                                    return_counts=True)))}}
        if gpu._l7_fast is not None:
            res.update(l7_fast_allow=int(counts[0]),
                       l7_fast_deny=int(counts[1]),
                       l7_redirect=int(counts[2]),
                       l7_oracle_rows=oracle_checked)
        emit(f"{leg}-{fam}-parity" if leg != "all" else "all-stages-parity",
             **res)
        out[leg] = res
    set_stages(gpu, "off", l7st)
    return out


def stage_timed(run, calls: int) -> dict:
    """Per-batch device time of ``calls`` steps on batches already on the
    card (CUDA events around the step alone), and the verdict shares
    over those batches (counted after each step's timing)."""
    ms, counts = [], {}
    for _ in range(calls):
        b = run.next_batch()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run.step(b)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        v = out[0]
        for name, mask in (("allow", v == 0),
                           ("policy_drop", v == VERDICT_DROP),
                           ("l7_drop", v == -3), ("threat_drop", v == -4),
                           ("proxy", v > 0)):
            counts[name] = counts.get(name, 0) + int(mask.sum())
        run.advance()
    res = {"batch": run.batch, **timing(ms, run.batch)}
    res["verdicts_per_s"] = res.pop("rows_per_s")
    res["verdict_share"] = {k: n / (calls * run.batch)
                            for k, n in counts.items()}
    return res


def timed_swap(fn) -> dict:
    """Host ms of one swap call, and ms until the card has done it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ret = fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return {"host_ms": host_ms,
            "done_ms": (time.perf_counter() - t0) * 1e3, "returned": ret}


def stage_swaps(run, leg: str, l7st) -> dict:
    """Between two timed batches: the threat legs flip the config and
    swap the weights (same geometry), the analytics leg swaps the epoch
    and decodes the quiesced section on the host.  Every swap must leave
    the table generation (``rebuilds``) and the live tensors as they
    were."""
    dp = run.dp
    out = {}
    before = dp.rebuilds
    if dp._threat is not None:
        ptrs = [getattr(dp._tables, n).data_ptr()
                for n in ("tm_w1", "tm_cfg")]
        stage_timed(run, 1)
        flipped = ThreatConfig() if dp._threat.config.mode == "enforce" \
            else threat_enforce_config(redirect=True)
        out["threat_config"] = timed_swap(
            lambda: dp.set_threat_config(flipped))
        stage_timed(run, 1)
        out["threat_config_back"] = timed_swap(
            lambda: dp.set_threat_config(
                threat_enforce_config(redirect=True) if leg != "threat-shadow"
                else ThreatConfig()))
        trainer = ThreatTrainer(epochs=30)
        trained = trainer.fit(dp.flow_snapshot(FLOW_SLOTS), now=run.now,
                              config=dp._threat.config)
        out["threat_trained"] = trainer.last_report
        out["threat_weights"] = timed_swap(
            lambda: dp.apply_threat_weights(trained))
        stage_timed(run, 1)
        out["threat_weights_back"] = timed_swap(
            lambda: dp.apply_threat_weights(default_model(
                dp._threat.config)))
        if not (out["threat_weights"]["returned"] and
                out["threat_weights_back"]["returned"]):
            raise AssertionError("a same-geometry weight swap rebuilt")
        if ptrs != [getattr(dp._tables, n).data_ptr()
                    for n in ("tm_w1", "tm_cfg")]:
            raise AssertionError("a threat swap replaced a live tensor")
    if dp.analytics_state is not None:
        ptr = dp.analytics_state.state.data_ptr()
        stage_timed(run, 1)
        out["epoch"] = timed_swap(dp.swap_analytics_epoch)
        stage_timed(run, 1)
        t0 = time.perf_counter()
        snap = dp.analytics_snapshot()
        sec = quiesced_section(snap, ANALYTICS["depth"],
                               ANALYTICS["lanes"])
        views = {"talkers": top_talkers(sec, ANALYTICS["depth"], k=5),
                 "scanners": top_scanners(sec, ANALYTICS["depth"], k=5),
                 "prefixes": top_prefixes(sec, ANALYTICS["depth"], k=5)}
        out["decode"] = {"ms": (time.perf_counter() - t0) * 1e3,
                         **{k: len(v) for k, v in views.items()},
                         "top_talker": views["talkers"][:1]}
        if not views["talkers"] or not views["prefixes"]:
            raise AssertionError("the analytics decode found no talker")
        if dp.analytics_state.state.data_ptr() != ptr:
            raise AssertionError("the epoch swap replaced the buffer")
    out["rebuilds"] = dp.rebuilds - before
    if out["rebuilds"]:
        raise AssertionError(f"{leg}: a swap rebuilt the tables")
    return out


def phase_stages(dev, state4) -> dict:
    """The fused optional stages at full width, v4 then v6; returns the
    dense kernel's launches during each phase (the paths run none)."""
    t0 = time.perf_counter()
    l7st = l7_serving_state(state4)
    st6 = v6_of(l7st.v4)
    emit("stages-state", programs=l7st.programs.describe(),
         http_net=f"{l7st.http_net >> 24}.{(l7st.http_net >> 16) & 255}"
                  ".0.0/16",
         dns_net=f"{l7st.dns_net >> 24}.{(l7st.dns_net >> 16) & 255}"
                 ".0.0/16",
         l7_flow_share=L7_FLOW_SHARE, bad_payload_shares=L7_BAD_SHARES,
         threat=THREAT, analytics=ANALYTICS,
         setup_s=time.perf_counter() - t0)
    launches = {}
    table = torch.as_tensor(l7st.table, device=dev)
    for family6 in (False, True):
        fam = "v6" if family6 else "v4"
        if family6:
            def load(dp):
                st6.v4.load(dp)
                st6.load(dp)
            make = l7_serving_packets6
        else:
            load = l7st.v4.load
            make = l7_serving_packets
        legs = STAGE_LEGS if not family6 else STAGE_LEGS[:-1]
        dv.dense_verdict.launches = 0
        t0 = time.perf_counter()
        parity = stage_parity(fam, dev, load, l7st, family6,
                              make(l7st, STAGE_SMALL,
                                   n_flows=V4_FLOWS // 16, seed=6),
                              legs[1:])
        parity_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        gen = make(l7st, STAGE_BATCH, n_flows=V4_FLOWS, seed=5)
        batches, payloads = [], []
        for _ in range(STAGE_CYCLE):
            packed, idx = next(gen)
            batches.append(torch.as_tensor(packed, device=dev))
            payloads.append(table[torch.as_tensor(idx, device=dev).long()])
        dp = engine.Datapath(ct_slots=V4_CT_SLOTS, ct_probe=V4_CT_PROBE,
                             device=dev)
        # timed like V4Run / V6Run: the step alone, without telemetry's
        # verdict-count reads
        dp.telemetry_enabled = False
        load(dp)
        enable_flows(dp)
        run = StageRun(dp, family6, batches, payloads)
        emit(f"stages-{fam}-setup", batches=STAGE_CYCLE, b=STAGE_BATCH,
             payload_mb=payloads[0].numel() * 4 / 1e6,
             seconds=time.perf_counter() - t0, parity_s=parity_s)
        base = None
        for leg in legs:
            t0 = time.perf_counter()
            # each leg from empty conntrack and flow tables; its first
            # pass over the batches (fresh flows) gives the shares of
            # what the stages decide, the later passes the timing
            run.reset()
            set_stages(dp, leg, l7st)
            first = stage_timed(run, STAGE_CYCLE)
            # the shadow leg runs the enforce leg's code (the armed
            # branch always runs), whose sync check follows
            sync = sync_check(run, FLOW_CLAIM_EVERY) \
                if leg not in ("off", "threat-shadow") else None
            # every leg is timed with provenance off, the daemon's default
            dp.disable_provenance()
            timed = stage_timed(run, STAGE_TIMED)
            prof = profile_run(run, STAGE_PROFILE)
            swaps = stage_swaps(run, leg, l7st) if leg != "off" else {}
            if leg == "off":
                base = (timed, prof)
            res = {"leg": leg, **timed,
                   "added_ms": timed["median_batch_ms"] -
                   base[0]["median_batch_ms"],
                   "kernels_per_step": prof["kernels_per_step"],
                   "added_kernels": prof["kernels_per_step"] -
                   base[1]["kernels_per_step"],
                   "busy_ms": prof["busy_ms"],
                   "added_busy_ms": prof["busy_ms"] - base[1]["busy_ms"],
                   "off_median_batch_ms": base[0]["median_batch_ms"],
                   "first_pass_share": first["verdict_share"],
                   "ct_entries": dp.ct_entries()[1 if family6 else 0],
                   "top": prof["top"][:8], "swaps": swaps,
                   "seconds": time.perf_counter() - t0}
            if sync is not None:
                emit(f"{leg}-{fam}-sync" if leg != "all"
                     else "all-stages-sync", **sync)
            if leg != "off":
                res["parity"] = parity[leg]
            emit(f"{leg}-{fam}" if leg != "all" else "all-stages", **res)
        set_stages(dp, "off", l7st)
        launches[fam] = dv.dense_verdict.launches
    return launches



# ---------------------------------------------------------------------------
# phase 10: the serving tier (lane, supervisor, verdict service)
# ---------------------------------------------------------------------------

# the daemon's supervision knobs (cilium_tpu/daemon/daemon.py:123-131 with
# the defaults of cilium_tpu/utils/option.py:272-289): a 10 s watchdog, 3
# consecutive transient faults, a 1 s reset, the oracle for new flows while
# degraded, 2**17 pending records; no admission deadline
SERVING_KNOBS = dict(watchdog_s=10.0, failure_threshold=3, reset_s=1.0,
                     new_flow_policy="oracle", max_pending=1 << 17)
SERVING_SUBMITTERS = 16
SERVING_CHUNKS = 6            # chunks per submitter in the parity leg
SERVING_MAX_CHUNK = 4096
SERVING_OUTSTANDING = 2       # tickets a submitter keeps unresolved
LATENCY_SIZES = (1, 16, 64, 256, 1024, 4096)
LATENCY_ITERS = 30
COALESCE_FRAMES = 40
THROUGHPUT_CHUNK = 4096
THROUGHPUT_ROUNDS = 12        # each submitter cycles its two chunks
THROUGHPUT_PROFILED = 4       # rounds of the profiled window
SERVICE_CLIENTS = 4
SERVICE_FRAMES = 64
SERVICE_BIG = 40_000          # records of a frame past the lane's max_batch
SERVICE_WINDOW = 64           # payload bytes a record on the wire
PAYLOAD_CLIENTS = 2
PAYLOAD_FRAMES = 24
PAYLOAD_L7_SHARE = 0.3        # rows aimed at the L7 redirects, half each
# payload bytes a record on the wire in the payload leg: past the
# engine's window, so rows longer than it are poisoned by the lane
PAYLOAD_WIRE_WINDOW = L7_WINDOW + 32
HANG_S = 1.5                  # the injected hang of one completion
HANG_WATCHDOG_S = 0.5


class RecordPool:
    """Record chunks over a v4 serving state: half the destinations inside
    the policy's prefixes on their identity's rule port (allowed), a
    tenth at service VIPs (DNAT), the rest random; egress, SYN, random
    source addresses, source ports from a counter, so no two records
    share a tuple (chunks never meet each other's CT entries)."""

    def __init__(self, state, seed: int = 41):
        nets = parse_prefixes(state.prefixes)
        self.net = np.array([n[0] for n in nets], np.int64)
        self.host = np.array([(~n[1]) & 0xFFFFFFFF for n in nets], np.int64)
        self.port = np.array([state.ident_port.get(n[3], 80) for n in nets],
                             np.int64)
        self.vip = np.array([s.vip for s in state.services], np.int64)
        self.vport = np.array([s.port for s in state.services], np.int64)
        self.n_ep = len(state.ep_identity)
        self.rng = np.random.default_rng(seed)
        self.sport = 0

    def chunk(self, n: int) -> dict:
        rng = self.rng
        kind = rng.random(n)
        daddr = rng.integers(0, 1 << 32, n, dtype=np.int64)
        dport = rng.integers(1, 65536, n)
        hit = kind < 0.5
        k = rng.integers(0, self.net.shape[0], int(hit.sum()))
        daddr[hit] = self.net[k] | (rng.integers(0, 1 << 32, k.shape[0])
                                    & self.host[k])
        dport[hit] = self.port[k]
        svc = kind >= 0.9
        j = rng.integers(0, self.vip.shape[0], int(svc.sum()))
        daddr[svc] = self.vip[j]
        dport[svc] = self.vport[j]
        base = self.sport
        self.sport += n
        i32 = lambda a: np.asarray(a, np.int64).astype(  # noqa: E731
            np.uint32).view(np.int32)
        return {"endpoint": rng.integers(0, self.n_ep, n).astype(np.int32),
                "saddr": i32(rng.integers(0, 1 << 32, n, dtype=np.int64)),
                "daddr": i32(daddr),
                "sport": ((base + np.arange(n)) % 64000 + 1024
                          ).astype(np.int32),
                "dport": dport.astype(np.int32),
                "proto": np.full(n, 6, np.int32),
                "direction": np.ones(n, np.int32),
                "tcp_flags": np.full(n, 0x02, np.int32),
                "is_fragment": np.zeros(n, np.int32),
                "length": np.full(n, 256, np.int32)}


def lane_status(lane, leg: str) -> dict:
    """A supervised lane's status, which must show the card serving:
    mode ok, no fault, no fail-static batch, no failed batch, no shed,
    and no staging slot replaced (every batch was waited on) (for the
    engine's lane, what ``Datapath.supervision_status`` reads)."""
    s = lane.stats()
    sup = s["supervisor"]
    out = {"mode": sup["mode"], "breaker": sup["breaker"],
           "faults": sup["faults"],
           "fail_static_batches": sup["fail-static"]["batches"],
           "static_batches": s["static-batches"], "errors": s["errors"],
           "shed": s["shed"], "recoveries": sup["recoveries"],
           "oracle_refreshes": sup["oracle"]["refreshes"],
           "staging_replaced": lane.staging_replaced}
    if sup["mode"] != "ok" or sup["faults"] or out["fail_static_batches"] \
            or out["static_batches"] or out["errors"] or s["shed"] \
            or lane.staging_replaced:
        raise AssertionError(f"{leg}: the lane did not serve from the "
                             f"card: {out}")
    return out


def submitters(lane, work, outstanding: int = SERVING_OUTSTANDING):
    """``len(work)`` threads, thread ``t`` submitting ``work[t]`` (a list
    of (soa, n)) in order with at most ``outstanding`` tickets
    unresolved; returns each thread's results in order."""
    results = [[] for _ in work]
    errors = []

    def run(t):
        try:
            pending = deque()
            for soa, n in work[t]:
                pending.append(lane.submit_records(soa, n))
                while len(pending) >= outstanding:
                    tk = pending.popleft()
                    results[t].append(tk.result(timeout=300))
                    if tk.error is not None:
                        raise tk.error
            while pending:
                tk = pending.popleft()
                results[t].append(tk.result(timeout=300))
                if tk.error is not None:
                    raise tk.error
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(t,))
               for t in range(len(work))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
        if th.is_alive():
            raise AssertionError("a submitter did not finish")
    if errors:
        raise AssertionError(f"submitters failed: {errors[:3]}")
    return results


def alone_on_cpu(cpu, soa, n):
    """The CPU twin's (verdict, identity) for one chunk alone, unpadded."""
    packed = torch.as_tensor(np.stack([soa[f][:n] for f in PACKED_FIELDS]))
    v, _e, i, _nat = cpu.process_packed(packed)
    return v.numpy(), i.numpy()


def lane_counts(lane) -> dict:
    st = lane.stats()
    return {"batches": st["batches"], "items": st["items"]}


def batch_stats(before, after) -> dict:
    b = after["batches"] - before["batches"]
    items = after["items"] - before["items"]
    return {"batches": b, "records": items,
            "mean_batch": items / b if b else 0.0}


def serving_parity(dp, cpu, lane, pool) -> dict:
    t0 = time.perf_counter()
    work = [[(c, len(c["sport"])) for c in
             (pool.chunk(int(pool.rng.integers(1, SERVING_MAX_CHUNK + 1)))
              for _ in range(SERVING_CHUNKS))]
            for _ in range(SERVING_SUBMITTERS)]
    before = lane_counts(lane)
    results = submitters(lane, work)
    served_s = time.perf_counter() - t0
    mism = {"verdict": 0, "identity": 0}
    verdicts = {"drop": 0, "allow": 0, "proxy": 0}
    for chunks, outs in zip(work, results):
        for (soa, n), (v, i) in zip(chunks, outs):
            cv, ci = alone_on_cpu(cpu, soa, n)
            mism["verdict"] += int((v != cv).sum()) + abs(len(v) - n)
            mism["identity"] += int((i != ci).sum())
            verdicts["drop"] += int((v < 0).sum())
            verdicts["allow"] += int((v == 0).sum())
            verdicts["proxy"] += int((v > 0).sum())
    res = {"submitters": SERVING_SUBMITTERS, "chunks":
           SERVING_SUBMITTERS * SERVING_CHUNKS,
           **batch_stats(before, lane_counts(lane)),
           "mismatches": mism, "verdicts": verdicts, "served_s": served_s,
           "seconds": time.perf_counter() - t0,
           "status": lane_status(lane, "serving-parity")}
    emit("serving-parity", **res)
    if any(mism.values()):
        raise AssertionError(f"serving lane != CPU twin: {mism}")
    return res


def percentiles(seconds) -> dict:
    us = np.asarray(seconds) * 1e6
    return {"p50_us": float(np.percentile(us, 50)),
            "p99_us": float(np.percentile(us, 99)),
            "max_us": float(us.max()), "samples": len(us)}


def stage_ms(family: str) -> dict:
    """Mean host ms a batch of the lane's stages since the last reset."""
    rep = stages.pipeline_report().get(family, {})
    return {name: rep[name]["mean-us"] / 1e3 for name in
            ("queue-wait", "pack", "dispatch", "complete") if name in rep}


def fresh_view(sup) -> None:
    """Wait for the refresh of ``sup``'s host view in flight to end, or
    refresh it here when none is: none starts for the next
    ``ORACLE_REFRESH_S`` (5 s), so a timed window shorter than that
    holds none (a refresh decodes the whole CT under the GIL, 1-3 s at
    this width)."""
    if sup._refreshing.acquire(blocking=False):
        try:
            sup.oracle.refresh()
        finally:
            sup._refreshing.release()
    else:
        with sup._refreshing:
            pass


def refreshes_since(sup, before: int) -> int:
    """Host-view refreshes finished since ``before``, plus one in
    flight."""
    return sup.oracle.refreshes - before + int(sup._refreshing.locked())


def serving_latency(dp, lane, pool) -> list:
    """``bench_suite.py``'s latency-tier protocol on the card: per size,
    the sync round trip (``process_packed`` of a pinned batch copied to
    the card, then a host read of its verdicts), then a lane of that
    batch size (``max_batch = b``, as the bench's, under a supervisor
    with the daemon's knobs) unloaded (submit, resolve) and its
    streaming interval at depth 2; the same records every iteration, so
    they are established after the first.  Then 16 submitters of
    single-record frames through the engine's lane.  Each timed lane
    window starts from a fresh host view, so no refresh falls in it (as
    none falls in the sync windows); ``refreshes_in_windows`` counts any
    that did."""
    rows = []
    dev = dp.device
    knobs = {k: v for k, v in SERVING_KNOBS.items() if k != "max_pending"}
    for b in LATENCY_SIZES:
        sized = VerdictDispatcher(dp, max_batch=b, min_rows=min(b, 16),
                                  lane=f"lat{b}",
                                  supervisor=DeviceSupervisor(dp, **knobs))
        recs = pool.chunk(b)
        stage_t, stage_np = host_buffer((len(PACKED_FIELDS), b),
                                        dev.type == "cuda")
        for fi, f in enumerate(PACKED_FIELDS):
            stage_np[fi] = recs[f]

        def sync_step():
            v = dp.process_packed(stage_t.to(dev, non_blocking=True))[0]
            return v.cpu()

        for _ in range(3):
            sync_step()
        sync = []
        for _ in range(LATENCY_ITERS):
            t1 = time.perf_counter()
            sync_step()
            sync.append(time.perf_counter() - t1)
        try:
            for _ in range(4):
                sized.submit_records(recs, b).result(timeout=300)
            sup = sized.supervisor
            fresh_view(sup)
            stages.reset()
            before = sup.oracle.refreshes
            unloaded = []
            for _ in range(LATENCY_ITERS):
                t1 = time.perf_counter()
                sized.submit_records(recs, b).result(timeout=300)
                unloaded.append(time.perf_counter() - t1)
            host = stage_ms(sized.family)
            in_windows = refreshes_since(sup, before)
            fresh_view(sup)
            stages.reset()
            before = sup.oracle.refreshes
            tickets = []
            t0 = time.perf_counter()
            for k in range(LATENCY_ITERS):
                tickets.append(sized.submit_records(recs, b))
                if k >= 2:
                    tickets[k - 2].result(timeout=300)
            for tk in tickets:
                tk.result(timeout=300)
            interval = (time.perf_counter() - t0) / LATENCY_ITERS
            streaming_host = stage_ms(sized.family)
            in_windows += refreshes_since(sup, before)
            status = lane_status(sized, "serving-latency")
            launched = sized.batches
        finally:
            sized.close()
        row = {"b": b, "sync": percentiles(sync),
               "serving": percentiles(unloaded),
               "streaming_interval_us": interval * 1e6,
               "batches": launched,
               "stage_host_ms": host,
               "streaming_stage_host_ms": streaming_host,
               "refreshes_in_windows": in_windows,
               "status": status}
        emit("serving-latency", **row)
        rows.append(row)
    # coalescing: concurrent single-record submitters
    frames = [[pool.chunk(1) for _ in range(COALESCE_FRAMES)]
              for _ in range(SERVING_SUBMITTERS)]
    lane.submit_records(pool.chunk(1), 1).result(timeout=300)
    fresh_view(lane.supervisor)
    refreshes0 = lane.supervisor.oracle.refreshes
    per_frame, order, lock = [], [], threading.Lock()

    def one(t):
        for k, soa in enumerate(frames[t]):
            t1 = time.perf_counter()
            lane.submit_records(soa, 1).result(timeout=300)
            with lock:
                per_frame.append(time.perf_counter() - t1)
                order.append(k)

    before = lane_counts(lane)
    threads = [threading.Thread(target=one, args=(t,))
               for t in range(SERVING_SUBMITTERS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    counts = batch_stats(before, lane_counts(lane))
    slowest = np.argsort(per_frame)[-5:]
    row = {"submitters": SERVING_SUBMITTERS,
           "frames": len(per_frame), **percentiles(per_frame),
           # each slow frame's place in its submitter's sequence
           "slowest_frame_index": [order[j] for j in slowest],
           "records_per_launch": counts["mean_batch"],
           "batches": counts["batches"],
           "refreshes_in_windows": refreshes_since(lane.supervisor,
                                                   refreshes0),
           "status": lane_status(lane, "serving-coalesce")}
    emit("serving-coalesce", **row)
    rows.append(row)
    return rows


def device_busy_ms(fn) -> tuple:
    """(fn's result, device busy ms, kernels, wall s) over one call of
    ``fn`` under ``torch.profiler``'s CUDA activity; the wall clock runs
    inside the profiled window, from the call until the card is done."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    return out, busy, sum(e.count for e in kernels), wall


def serving_throughput(dp, lane, pool) -> dict:
    """16 submitters of 4,096-record chunks through the lane (coalesced
    up to its max_batch of 2**15), each cycling two chunks
    ``THROUGHPUT_ROUNDS`` times with two tickets outstanding: records/s
    and the mean batch; then fewer rounds under the profiler for the
    card's busy share: its busy ms over the wall ms of the same profiled
    window (the profiler slows the host, so this share is lower than in
    the unprofiled window)."""
    mine = [[pool.chunk(THROUGHPUT_CHUNK) for _ in range(2)]
            for _ in range(SERVING_SUBMITTERS)]
    work = [[(c[r % 2], THROUGHPUT_CHUNK) for r in range(THROUGHPUT_ROUNDS)]
            for c in mine]
    submitters(lane, [w[:2] for w in work])   # first use of the chunks
    shed0 = sum(lane.stats()["shed"].values())
    before = lane_counts(lane)
    t0 = time.perf_counter()
    submitters(lane, work)
    wall = time.perf_counter() - t0
    counts = batch_stats(before, lane_counts(lane))
    before_p = lane_counts(lane)
    _, busy_ms, kernels, wall_p = device_busy_ms(
        lambda: submitters(lane, [w[:THROUGHPUT_PROFILED] for w in work]))
    counts_p = batch_stats(before_p, lane_counts(lane))
    batches_p = max(1, counts_p["batches"])
    res = {"submitters": SERVING_SUBMITTERS, "chunk": THROUGHPUT_CHUNK,
           "max_batch": lane.max_batch, **counts, "seconds": wall,
           "records_per_s": counts["records"] / wall,
           "wall_ms_per_batch": wall * 1e3 / max(1, counts["batches"]),
           "busy_share": busy_ms / (wall_p * 1e3),
           "profiled": {"seconds": wall_p, **counts_p,
                        "records_per_s": counts_p["records"] / wall_p,
                        "wall_ms_per_batch": wall_p * 1e3 / batches_p,
                        "busy_ms_per_batch": busy_ms / batches_p,
                        "kernels_per_batch": kernels / batches_p},
           "shed": sum(lane.stats()["shed"].values()) - shed0,
           "status": lane_status(lane, "serving-throughput")}
    emit("serving-throughput", **res)
    return res


def records_of(soa) -> np.ndarray:
    """A record chunk as the wire's ``PKT_HEADER_DTYPE`` records."""
    recs = np.zeros(len(soa["sport"]), PKT_HEADER_DTYPE)
    for f in PKT_HEADER_DTYPE.names:
        recs[f] = soa[f].view(np.uint32) if f in ("saddr", "daddr") \
            else soa[f]
    return recs


def verdict_service_leg(dp, lane, pool) -> dict:
    """4 clients of 64 frames each over loopback, a third of them with a
    payload lane and one each larger than the lane's max_batch; then
    the same records straight into the lane, in order: the answers must
    be equal (each record's flow is established by then, and keeps the
    verdict it got)."""
    rng = np.random.default_rng(43)
    plan = []
    for c in range(SERVICE_CLIENTS):
        frames = []
        for k in range(SERVICE_FRAMES):
            n = SERVICE_BIG if k == 5 else \
                int(rng.integers(1, SERVING_MAX_CHUNK + 1))
            soa = pool.chunk(n)
            recs = records_of(soa)
            pl = None
            if k % 3 == 1:
                strings = [None if rng.random() < 0.2 else
                           f"GET\x00/api/{int(x)}\x00svc"
                           for x in rng.integers(0, 1 << 20, n)]
                pl = pack_wire_payloads(strings, SERVICE_WINDOW)
            frames.append((recs, pl))
        plan.append(frames)
    svc = VerdictService(dp).start()
    answers = [None] * SERVICE_CLIENTS
    errors = []

    def client(c):
        cl = VerdictClient("127.0.0.1", svc.port)
        try:
            answers[c] = [cl.classify(r, payloads=p) for r, p in plan[c]]
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))
        finally:
            cl.close()

    before = lane_counts(lane)
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVICE_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        counts = batch_stats(before, lane_counts(lane))
        served = svc.frames_served
    finally:
        svc.shutdown()
    if errors:
        raise AssertionError(f"verdict-service clients failed: {errors}")
    mism = {"verdict": 0, "identity": 0, "count": 0}
    for c in range(SERVICE_CLIENTS):
        for (recs, pl), (v, i) in zip(plan[c], answers[c]):
            n = len(recs)
            soa = {f: recs[f].astype(np.int64).astype(np.uint32).view(
                np.int32) if f in ("saddr", "daddr") else
                recs[f].astype(np.int32) for f in PKT_HEADER_DTYPE.names}
            payload = None if pl is None else _decode_wire_payloads(
                pl.tobytes(), n, SERVICE_WINDOW)
            tk = lane.submit_records(soa, n, payload=payload)
            dv, di = tk.result(timeout=300)
            mism["count"] += int(len(v) != n)
            mism["verdict"] += int((v != dv).sum())
            mism["identity"] += int((i != di).sum())
    res = {"clients": SERVICE_CLIENTS, "frames": served,
           "records": sum(len(r) for fr in plan for r, _p in fr),
           "payload_frames": sum(p is not None for fr in plan
                                 for _r, p in fr),
           "big_frames": sum(len(r) > lane.max_batch for fr in plan
                             for r, _p in fr),
           **counts, "seconds": wall, "mismatches": mism,
           "status": lane_status(lane, "verdict-service")}
    emit("verdict-service", **res)
    if any(mism.values()) or served != SERVICE_CLIENTS * SERVICE_FRAMES:
        raise AssertionError(f"verdict service != direct lane: {res}")
    return res


def l7_frame(pool, l7st, rng, n: int, picked=None):
    """``n`` records of ``pool`` with ``PAYLOAD_L7_SHARE`` of them aimed
    at ``l7st``'s redirects (HTTP ingress :80 from its HTTP /16, DNS
    egress :53 to its DNS /16) and one match string a row: the state's
    requests and names, None (absent), and strings 1-32 bytes past the
    engine's window; other rows carry a request, which no program
    reads.  Returns (soa, strings); a ``picked`` list receives each
    row's request or name before it was made absent or overlong."""
    soa = pool.chunk(n)
    u = rng.random(n)
    http = u < PAYLOAD_L7_SHARE / 2
    dns = ~http & (u < PAYLOAD_L7_SHARE)
    peer = rng.integers(0, 1 << 16, n)
    as_i32 = lambda a: a.astype(np.uint32).view(np.int32)  # noqa: E731
    soa["saddr"][http] = as_i32(l7st.http_net + peer[http])
    soa["direction"][http] = 0
    soa["dport"][http] = 80
    soa["daddr"][dns] = as_i32(l7st.dns_net + peer[dns])
    soa["dport"][dns] = 53
    soa["proto"][dns] = 17
    soa["tcp_flags"][dns] = 0
    n_http = len(l7st.strings) - len(L7_DNS_NAMES) - 2
    reqs, names = l7st.strings[:n_http], l7st.strings[n_http:-2]
    strings = []
    for j in range(n):
        pick = names if dns[j] else reqs
        s = pick[int(rng.integers(len(pick)))]
        if picked is not None:
            picked.append(s)
        k = rng.random()
        if (http[j] or dns[j]) and k < 0.1:
            s = None
        elif (http[j] or dns[j]) and k < 0.3:
            s += "x" * (L7_WINDOW + int(rng.integers(1, 33)) - len(s))
        strings.append(s)
    return soa, strings


def serving_payload(dp, cpu, lane, pool, state4) -> dict:
    """The payload lane on the card: both engines take the policy of
    ``l7_serving_state(state4)`` with the L7 fast verdict on (and
    ``state4``'s again, L7 fast off, at the end), then 2 clients send 24
    frames each of
    1-4,096 records with a payload lane ``PAYLOAD_WIRE_WINDOW`` wide
    through ``VerdictService``; the lane stages each payload into its
    pinned [rows, W] slot and poisons the rows longer than the engine's
    window W.  Every answer must equal the CPU twin's for its frame
    alone, with the payload encoded at W (rows past it poisoned there)."""
    t0 = time.perf_counter()
    l7st = l7_serving_state(state4)
    for eng in (dp, cpu):
        eng.load_policy(l7st.v4.states, revision=2,
                        ipcache_prefixes=l7st.v4.prefixes)
        set_stages(eng, "l7fast", l7st)
    width = dp.l7_fast_window()
    rng = np.random.default_rng(44)
    plan = [[l7_frame(pool, l7st, rng,
                      int(rng.integers(1, SERVING_MAX_CHUNK + 1)))
             for _ in range(PAYLOAD_FRAMES)]
            for _ in range(PAYLOAD_CLIENTS)]
    setup_s = time.perf_counter() - t0
    svc = VerdictService(dp).start()
    answers = [None] * PAYLOAD_CLIENTS
    errors = []

    def client(c):
        cl = VerdictClient("127.0.0.1", svc.port)
        try:
            answers[c] = [cl.classify(
                records_of(soa), payloads=pack_wire_payloads(
                    strings, PAYLOAD_WIRE_WINDOW))
                for soa, strings in plan[c]]
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))
        finally:
            cl.close()

    before = lane_counts(lane)
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(PAYLOAD_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        counts = batch_stats(before, lane_counts(lane))
    finally:
        svc.shutdown()
    if errors:
        raise AssertionError(f"serving-payload clients failed: {errors}")
    mism = {"verdict": 0, "identity": 0, "count": 0}
    aimed = {"allow": 0, "deny_l7": 0, "redirect": 0, "other_drop": 0}
    past = past_redirected = 0
    for c in range(PAYLOAD_CLIENTS):
        for (soa, strings), (v, i) in zip(plan[c], answers[c]):
            n = len(strings)
            packed = torch.as_tensor(np.stack([soa[f][:n]
                                               for f in PACKED_FIELDS]))
            cv, _e, ci, _nat = cpu.process_packed(
                packed, payload=torch.as_tensor(
                    encode_payloads(strings, width)))
            cv, ci = cv.numpy(), ci.numpy()
            mism["count"] += int(len(v) != n)
            mism["verdict"] += int((v != cv).sum())
            mism["identity"] += int((i != ci).sum())
            l7 = ((soa["dport"][:n] == 80) & (soa["direction"][:n] == 0)) | \
                ((soa["dport"][:n] == 53) & (soa["proto"][:n] == 17))
            aimed["allow"] += int((l7 & (v == 0)).sum())
            aimed["deny_l7"] += int((l7 & (v == VERDICT_DROP_L7)).sum())
            aimed["redirect"] += int((l7 & (v > 0)).sum())
            aimed["other_drop"] += int((l7 & (v < 0) &
                                        (v != VERDICT_DROP_L7)).sum())
            long_row = np.array([s is not None and len(s.encode()) > width
                                 for s in strings])
            past += int((l7 & long_row).sum())
            past_redirected += int((l7 & long_row & (v > 0)).sum())
    for eng in (dp, cpu):
        set_stages(eng, "off", l7st)
        eng.load_policy(state4.states, revision=3,
                        ipcache_prefixes=state4.prefixes)
    res = {"clients": PAYLOAD_CLIENTS, "frames": PAYLOAD_CLIENTS *
           PAYLOAD_FRAMES, "wire_window": PAYLOAD_WIRE_WINDOW,
           "engine_window": width,
           "records": sum(len(st) for fr in plan for _s, st in fr),
           **counts, "seconds": wall, "setup_s": setup_s,
           "l7_rows": aimed, "l7_rows_past_window": past,
           "l7_rows_past_window_redirected": past_redirected,
           "mismatches": mism,
           "status": lane_status(lane, "serving-payload")}
    emit("serving-payload", **res)
    if any(mism.values()) or not aimed["allow"] or not aimed["deny_l7"] \
            or not past:
        raise AssertionError(f"serving-payload: {res}")
    return res


def wait_mode(sup, mode: str, submit, timeout: float = 60.0) -> float:
    """Submit chunks until the supervisor reads ``mode``; seconds."""
    t0 = time.perf_counter()
    while sup.mode != mode:
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"the lane did not reach {mode}: "
                                 f"{sup.stats()}")
        time.sleep(min(0.05, max(0.0, sup.breaker.retry_in())))
        submit()
    return time.perf_counter() - t0


def card_fail_static(dp, replay, soa, n: int) -> dict:
    """The fail-static answer for ``n`` records of ``soa`` with every
    input read from the card, none from the supervisor's host view: each
    forward and reply tuple looked up in the card's own CT table, each
    peer's identity in the card's ipcache, each row's new-flow verdict
    replayed through the card's policy tensors (``replay``, the
    engine's ``policy_replay``); the
    precedence is ``host_fail_static_step``'s (a live forward entry
    gives its recorded proxy port, a live reply entry 0, else the
    policy verdict).  Also, for each row, whether its whole probe window
    is live (a create finds no free slot) and whether its window holds
    the entry of another row of ``soa`` (a create can lose its slot to
    a new flow of the same batch: one winner a slot a batch)."""
    dev = dp.device
    col = {f: torch.as_tensor(np.ascontiguousarray(soa[f][:n])).to(dev)
           for f in ("saddr", "daddr", "sport", "dport", "proto",
                     "direction")}
    sa, da, sp, dpt, pr, di = (col[f] for f in ("saddr", "daddr", "sport",
                                                "dport", "proto",
                                                "direction"))
    with dp._lock:
        ct, tables = dp.ct, dp._tables.datapath
        now = dp._timestamp(None)
        keys = (sa, da, conntrack._pack_k2(sp, dpt),
                conntrack._pack_k3(pr, di))
        fwd, slot = conntrack._lookup(ct.state, *keys, now, ct.slots,
                                      ct.max_probe)
        held = slot[fwd]
        rev, _ = conntrack._lookup(
            ct.state, da, sa, conntrack._pack_k2(dpt, sp),
            conntrack._pack_k3(pr, 1 - di), now, ct.slots, ct.max_probe)
        proxy = ct.state[conntrack.FIELDS.index("proxy_port")][slot.long()]
        idx = conntrack._probe_idx(*keys, ct.slots, ct.max_probe).long()
        window_full = ((ct.state[conntrack.FIELDS.index("k3")][idx] != 0) &
                       (ct.state[conntrack.FIELDS.index("expires")][idx] >
                        now)).all(dim=1)
        mate = torch.isin(idx, held.long()).any(dim=1)
        found, ident = lpm_lookup(
            tables.lpm_masks, tables.lpm_key_a, tables.lpm_key_b,
            tables.lpm_value, tables.lpm_plens, torch.where(di == 0, sa, da),
            dp._statics["lpm_probe"])
        ident = torch.where(found, ident, WORLD_IDENTITY)
    fwd, rev, proxy, window_full, mate, ident = (
        t.cpu().numpy() for t in (fwd, rev, proxy, window_full, mate,
                                  ident))
    policy = np.array([r["verdict"] for r in replay(
        soa["endpoint"][:n], ident, soa["dport"][:n], soa["proto"][:n],
        soa["direction"][:n])], np.int32)
    return {"verdict": np.where(fwd, proxy, np.where(rev, 0, policy)),
            "identity": ident, "established": fwd | rev,
            "window_full": window_full, "window_holds_mate": mate}


def serving_fault(dp, cpu, lane, pool) -> list:
    """``failure_threshold`` transient launch faults, then one hung
    completion under a 0.5 s watchdog: each must take the lane
    fail-static, and after the fault clears the probe must rebuild the
    tables and replay the gate's rows on the card before the lane reads
    ok again; a fresh chunk then equals the CPU twin's answer.  While
    fail-static, every row of a chunk the card has seen (its allowed
    flows established) and of a fresh chunk must equal
    ``card_fail_static`` (inputs read from the card, not from the
    oracle), and the fresh chunk also ``host_fail_static_step`` over the
    oracle's view (the lane answers from that oracle)."""
    sup = lane.supervisor
    inj = DeviceFaultInjector()
    sup.install_fault_hook(inj)
    replayed, recovering = [], []
    replay, recover = dp.policy_replay, sup._recover

    def counting_replay(*cols):
        out = replay(*cols)
        replayed.append((len(out), dp.device.type))
        return out

    def timed_recover():
        t0 = time.perf_counter()
        ok = recover()
        recovering.append((time.perf_counter() - t0, ok))
        return ok

    dp.policy_replay = counting_replay
    sup._recover = timed_recover

    def submit(n=64, soa=None):
        soa = soa if soa is not None else pool.chunk(n)
        tk = lane.submit_records(soa, n)
        v, i = tk.result(timeout=300)
        if tk.error is not None:
            raise AssertionError(f"fail-closed while supervised: {tk.error}")
        return v, i

    rows = []
    try:
        est = pool.chunk(2048)
        v_est, _ = submit(2048, est)
        with sup._refreshing:   # a view that holds est's CT entries
            t0 = time.perf_counter()
            sup.oracle.refresh()
            refresh_s = time.perf_counter() - t0
        card = card_fail_static(dp, replay, est, 2048)
        # the allowed rows the card's CT does not hold on their own
        # tuple, by cause: a DNAT'd flow's entry is on its backend's
        # tuple (fail-static answers policy, not NAT); a create found
        # its probe window full, or lost its slot to a flow of its batch
        svc = set(zip(pool.vip.tolist(), pool.vport.tolist()))
        dnat = np.array([(int(a), int(p)) in svc for a, p in zip(
            est["daddr"].view(np.uint32), est["dport"])])
        left = (v_est >= 0) & ~card["established"]
        causes = {}
        for cause, hit in (("dnat", dnat),
                            ("probe_window_full", card["window_full"]),
                            ("slot_taken_by_batch_mate",
                             card["window_holds_mate"]),
                            ("other", np.ones(2048, bool))):
            causes[cause] = int((left & hit).sum())
            left &= ~hit
        rows_of = {"allowed": int((v_est >= 0).sum()),
                   "established": int(card["established"].sum()),
                   "allowed_not_established": causes,
                   "ct_fill": dp.ct_entries()[0] / dp.ct.slots}
        # an established row's entry holds what the card answered it
        recorded_mism = int((card["verdict"][card["established"]] !=
                             np.maximum(v_est, 0)[card["established"]]
                             ).sum())
        for kind in ("transient", "hung"):
            replayed.clear()
            recovering.clear()
            rebuilds = dp.rebuilds
            t0 = time.perf_counter()
            if kind == "transient":
                inj.fail_launch(times=SERVING_KNOBS["failure_threshold"])
                for _ in range(SERVING_KNOBS["failure_threshold"]):
                    submit(16)
            else:
                sup.watchdog_s = HANG_WATCHDOG_S
                inj.hang_finalize(seconds=HANG_S)
                submit(16)
            to_static = time.perf_counter() - t0
            mode = sup.mode
            v_static, i_static = submit(2048, est)
            est_mism = int((v_static != card["verdict"]).sum() +
                           (i_static != card["identity"]).sum())
            fresh = pool.chunk(2048)
            v_new, i_new = submit(2048, fresh)
            card_new = card_fail_static(dp, replay, fresh, 2048)
            new_mism = int((v_new != card_new["verdict"]).sum() +
                           (i_new != card_new["identity"]).sum())
            with sup.oracle._mu:
                want_v, want_i = host_fail_static_step(
                    fresh, 2048, established=sup.oracle._established,
                    identity_of=sup.oracle._identity_of,
                    policy_verdict=sup.oracle._policy_verdict)
            oracle_mism = int((v_new != want_v).sum() +
                              (i_new != want_i).sum())
            inj.heal()
            if kind == "hung":
                time.sleep(HANG_S)   # the abandoned worker's call ends
            t1 = time.perf_counter()
            recover_s = wait_mode(sup, "ok", lambda: submit(16))
            after = pool.chunk(2048)
            v_after, i_after = submit(2048, after)
            cv, ci = alone_on_cpu(cpu, after, 2048)
            row = {"kind": kind, "watchdog_s": sup.watchdog_s,
                   "mode_after_fault": mode,
                   "seconds_to_fail_static": to_static,
                   "seen_chunk_mismatches": est_mism,
                   "seen_chunk_rows": rows_of,
                   "recorded_verdict_mismatches": recorded_mism,
                   "new_flow_mismatches": new_mism,
                   "new_flows_established": int(
                       card_new["established"].sum()),
                   "oracle_mismatches": oracle_mism,
                   "seconds_to_recovery": recover_s,
                   "recovered_at_s": time.perf_counter() - t1,
                   "rebuilds": dp.rebuilds - rebuilds,
                   "rebuild_and_gate_s": [t for t, _ok in recovering],
                   "gate_passed": [ok for _t, ok in recovering],
                   "replayed_rows": sum(n for n, _d in replayed),
                   "replay_device": sorted({d for _n, d in replayed}),
                   "after_recovery_mismatches": int((v_after != cv).sum() +
                                                    (i_after != ci).sum()),
                   "mode": sup.mode, "faults": dict(sup.faults),
                   "recoveries": sup.recoveries,
                   "fail_static": sup.stats()["fail-static"],
                   "oracle": sup.oracle.stats(),
                   "oracle_refresh_s": refresh_s}
            emit("serving-fault", **row)
            rows.append(row)
            sup.watchdog_s = SERVING_KNOBS["watchdog_s"]
            bad = mode != "degraded" or est_mism or new_mism or \
                oracle_mism or recorded_mism or \
                row["after_recovery_mismatches"] or sup.mode != "ok" or \
                not replayed or row["rebuilds"] < 1 or \
                row["replay_device"] != [dp.device.type]
            if bad:
                raise AssertionError(f"serving-fault {kind}: {row}")
    finally:
        sup._hook = None
        sup.watchdog_s = SERVING_KNOBS["watchdog_s"]
        dp.policy_replay = replay
        sup._recover = recover
    return rows


def phase_serving(dev, state4) -> int:
    """The serving phase; returns the dense kernel's launches during it
    (the lane's step runs no hand-written kernel)."""
    t_phase = time.perf_counter()
    pair = []
    for where in (dev, torch.device("cpu")):
        dp = engine.Datapath(ct_slots=V4_CT_SLOTS, ct_probe=V4_CT_PROBE,
                             device=where)
        state4.load(dp)
        enable_flows(dp)
        pair.append(dp)
    dp, cpu = pair
    cpu.telemetry_enabled = False
    dp.configure_supervision(**SERVING_KNOBS)
    lane = dp.serving()
    pool = RecordPool(state4)
    emit("serving-state", ct_slots=V4_CT_SLOTS, flows_on=True,
         knobs=SERVING_KNOBS, lane_max_batch=lane.max_batch,
         depth=lane.depth, setup_s=time.perf_counter() - t_phase)
    dv.dense_verdict.launches = 0
    try:
        parity = serving_parity(dp, cpu, lane, pool)
        latency = serving_latency(dp, lane, pool)
        throughput = serving_throughput(dp, lane, pool)
        service = verdict_service_leg(dp, lane, pool)
        payload = serving_payload(dp, cpu, lane, pool, state4)
        faults = serving_fault(dp, cpu, lane, pool)
        launches = dv.dense_verdict.launches
    finally:
        lane.close()
    by_b = {r["b"]: r for r in latency if "b" in r}
    emit("serving", seconds=time.perf_counter() - t_phase,
         hand_kernel_launches={"dense_verdict": launches},
         parity_mismatches=sum(parity["mismatches"].values()),
         service_mismatches=sum(service["mismatches"].values()),
         payload_mismatches=sum(payload["mismatches"].values()),
         p99_us={b: {"sync": r["sync"]["p99_us"],
                     "serving": r["serving"]["p99_us"]}
                 for b, r in by_b.items()},
         records_per_s=throughput["records_per_s"],
         busy_share=throughput["busy_share"],
         fail_static_s=[f["seconds_to_fail_static"] for f in faults],
         recovery_s=[f["seconds_to_recovery"] for f in faults],
         name_power_limit=nvidia_smi("name,power.limit"))
    return launches


# ---------------------------------------------------------------------------
# phase 11: rules to verdicts
# ---------------------------------------------------------------------------

POLICY_STATE = (1000, 16, 24, 24)   # policy_state(): rules, endpoints,
POLICY_PROPAGATION = (100, 16, 24, 8)   # peers, CIDRs
POLICY_BATCH = 1 << 20
POLICY_CT_SLOTS = 1 << 21
POLICY_NOW = V4_T0
POLICY_TIMED = 25
POLICY_CYCLE = 4          # distinct batches the timed process_packed cycles
POLICY_CHANGES = 10       # single-rule adds, and as many deletes
POLICY_PROBE_BATCH = 4096  # rows of each batch served while a change spreads
POLICY_WORKERS = 6        # repository-oracle processes (the twin has its own)
POLICY_WAIT_S = 300.0


def policy_outputs(run, outs, rename=None) -> dict:
    """Every output of one ``process_packed`` on a ``PolicyRun`` and every
    buffer it wrote (every CT field, sentinel included, and both
    counters of every policy entry), as numpy copies.  ``rename``
    ({identity: identity}) renames identities in the identity output
    and before the counters are put in key order."""
    verdict, event, identity, nat = outs
    dp = run.datapath
    if rename is not None:
        identity = torch.as_tensor(rename_ids(identity.cpu().numpy(),
                                              rename))
    got = {"verdict": verdict, "event": event, "identity": identity}
    got.update({f"nat.{f}": getattr(nat, f) for f in nat._fields})
    n = dp.ct.slots + 1
    got.update({f"ct.{f}": dp.ct.state[i, :n]
                for i, f in enumerate(conntrack.FIELDS)})
    # the table geometry grows in build order, which the builder threads
    # interleave: each counter is taken at its entry, in key order
    key_id, key_meta, _ = run.table_mgr.host_mirror()
    if rename is not None:
        key_id = rename_ids(key_id, rename)
    ep, col = np.nonzero(key_meta)
    at = (ep * key_meta.shape[1] + col)[np.lexsort(
        (key_meta[ep, col], key_id[ep, col], ep))]
    at = torch.as_tensor(at, device=dp.device)
    got.update({f"counters.{f}": getattr(dp.counters, f)[at]
                for f in ("packets", "bytes")})
    # copies: on the CPU .cpu() would alias buffers later calls update
    return {k: t.to("cpu", copy=True).numpy() for k, t in got.items()}


def policy_map_states(run, rename=None) -> dict:
    """{table slot: {(identity, port, proto, direction): proxy port}},
    identities renamed through the dict ``rename`` where given."""
    rename = rename or {}
    return {slot: {(rename.get(k.identity, k.identity), k.dest_port,
                    k.nexthdr, k.direction): e.proxy_port
                   for k, e in st.items()}
            for slot, st in run.table_mgr.states_by_slot().items()}


def policy_twin(state, packed, ct_slots: int) -> dict:
    """The CPU twin (a worker process): ``state``'s rules imported from
    their JSON into a ``PolicyRun`` on the CPU, ``packed`` served once
    at ``POLICY_NOW``; its outputs and buffers, redirects, map states and
    endpoint states."""
    run = PolicyRun.from_state(state, device="cpu", ct_slots=ct_slots)
    try:
        if not run.wait_for_policy_revision(timeout=POLICY_WAIT_S):
            raise RuntimeError("the CPU twin's builds did not finish")
        outs = run.datapath.process_packed(torch.as_tensor(packed),
                                           now=POLICY_NOW)
        return {"outputs": policy_outputs(run, outs),
                "redirects": {r.id: r.proxy_port
                              for r in run.proxy.redirects()},
                "states": policy_map_states(run),
                "endpoint_states": run.endpoint_states(),
                "revision": run.repo.revision}
    finally:
        run.shutdown()


def policy_oracle(rules_json: str, rows) -> list:
    """(allowed, covered, redirected) of each (endpoint labels, remote
    labels, port, "TCP"/"UDP", egress) row by the port's repository over
    the rules of ``rules_json`` (a worker process).  ``allowed``:
    ``allows_ingress`` / ``allows_egress``.  ``covered``: the endpoint's
    own L4 policy (resolved for the endpoint alone, as a regeneration
    resolves it) has a filter for the port that selects the remote.
    ``redirected``: covered, and that filter is a redirect, unless it
    selects every peer and the remote is allowed at L3 (the
    L3-only entry never redirects, policy.h:83)."""
    repo = Repository()
    repo.add_list(rules_from_json(rules_json))
    l4 = {}
    out = []
    for ep_labels, far_labels, port, proto, egress in rows:
        mine = LabelArray.parse(*ep_labels)
        far = LabelArray.parse(*far_labels)
        if egress:
            ctx = dict(from_labels=mine, to_labels=far)
            allows, label_access = repo.allows_egress, \
                repo.allows_egress_label_access
        else:
            ctx = dict(from_labels=far, to_labels=mine)
            allows, label_access = repo.allows_ingress, \
                repo.allows_ingress_label_access
        allowed = allows(SearchContext(dports=[Port(port, proto)], **ctx)) \
            == Decision.ALLOWED
        if (ep_labels, egress) not in l4:
            l4[ep_labels, egress] = (
                repo.resolve_l4_egress_policy(SearchContext(
                    from_labels=mine)) if egress else
                repo.resolve_l4_ingress_policy(SearchContext(
                    to_labels=mine)))
        flt = l4[ep_labels, egress].get(f"{port}/{proto}")
        covered = flt is not None and flt.matches_labels(far)
        redirected = covered and flt.is_redirect() and not (
                flt.allows_all_at_l3() and label_access(
                    SearchContext(**ctx)) == Decision.ALLOWED)
        out.append((allowed, covered, redirected))
    return out


def policy_oracle_verdicts(states, slot, identity, dport, proto,
                           direction) -> np.ndarray:
    """``oracle_verdict`` of every row, computed once per distinct
    (slot, identity, port, proto, direction)."""
    keys = np.stack([slot, identity, dport, proto, direction],
                    1).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    want = np.array([oracle_verdict(states[int(s)], int(i), int(p),
                                    int(pr), int(d))
                     for s, i, p, pr, d in uniq], np.int32)
    return want[inv.reshape(-1)]


def policy_twin_mismatches(card: dict, twin: dict, redirects: dict,
                           states: dict):
    """({output or buffer: differing elements}, ports renamed) between the
    card and the CPU twin, with "map_state": the differing map-state
    entries.  Proxy ports are handed out in build order, which the
    builder threads interleave, so the twin's ports are first renamed to
    the card's through their redirect ids (the two runs must hold the
    same redirects)."""
    if set(twin["redirects"]) != set(redirects):
        raise AssertionError("the CPU twin holds other redirects than the "
                             "card's run")
    rename = np.arange(PROXY_PORT_MAX + 1, dtype=np.int32)
    for rid, port in twin["redirects"].items():
        rename[port] = redirects[rid]
    renamed = sum(redirects[rid] != port
                  for rid, port in twin["redirects"].items())
    got = dict(twin["outputs"])
    for k in ("verdict", "ct.proxy_port"):
        v = got[k]
        got[k] = np.where(v > 0, rename[np.clip(v, 0, PROXY_PORT_MAX)], v)
    out = {k: int((card[k] != got[k]).sum()) if card[k].shape ==
           got[k].shape else max(card[k].size, got[k].size) for k in card}
    out["map_state"] = sum(
        len(set(st.items()) ^ {(key, int(rename[p]) if p else 0)
                               for key, p in
                               twin["states"].get(slot, {}).items()})
        for slot, st in states.items())
    return out, renamed


def policy_probes(run, state, count: int) -> list:
    """``count`` (endpoint index, peer index, port, rule dict): a rule
    that opens ingress from the peer to the endpoint on a port no rule
    names, for pairs the repository denies now and allows with it."""
    out = []
    for i, (_, _, ep_labels) in enumerate(state.endpoints):
        for j, (_, peer_labels) in enumerate(state.peers):
            port = state.stranger_ports[len(out) % len(state.stranger_ports)]
            rule_dict = {
                "endpointSelector": {"matchLabels": dict(
                    l.split("=", 1) for l in ep_labels)},
                "ingress": [{"fromEndpoints": [{"matchLabels": dict(
                    l.split("=", 1) for l in peer_labels)}],
                    "toPorts": [{"ports": [{"port": str(port),
                                            "protocol": "TCP"}]}]}],
                "labels": [f"k8s:rule=p{len(out)}"]}
            ctx = SearchContext(from_labels=LabelArray.parse(*peer_labels),
                                to_labels=LabelArray.parse(*ep_labels),
                                dports=[Port(port, "TCP")])
            scratch = Repository()
            scratch.add_list(run.repo.rules +
                             rules_from_json(json.dumps(rule_dict)))
            if run.repo.allows_ingress(ctx) != Decision.ALLOWED and \
                    scratch.allows_ingress(ctx) == Decision.ALLOWED:
                out.append((i, j, port, rule_dict))
                break
        if len(out) == count:
            return out
    raise AssertionError(f"only {len(out)} probe flows of {count}")


def policy_propagation(dev) -> dict:
    """Single-rule adds and deletes on a BASELINE-config-1-sized state:
    each timed from ``policy_add`` / ``policy_delete`` (``repo.add_list``
    / ``delete_by_labels``) to the engine's ``on_revision_served`` and to
    the first batch in which the flow the rule opens or closes flips."""
    state = policy_state(*POLICY_PROPAGATION)
    run = PolicyRun.from_state(state, device=dev)
    samples = []
    try:
        if not run.wait_for_policy_revision(timeout=POLICY_WAIT_S):
            raise AssertionError("propagation state: builds did not finish")
        served = {}
        run.datapath.on_revision_served = \
            lambda rev: served.setdefault(rev, time.perf_counter())
        batch, _ = policy_packets(state, policy_remotes(state),
                                  POLICY_PROBE_BATCH, seed=21)
        rows = {f: PACKED_FIELDS.index(f) for f in PACKED_FIELDS}
        sport = iter(range(1024, 1 << 30))
        for k, (i, j, port, rule_dict) in enumerate(
                policy_probes(run, state, POLICY_CHANGES)):
            ep_ip = state.endpoints[i][1]
            for f, v in (("endpoint", i), ("dport", port), ("proto", 6),
                         ("direction", 0), ("tcp_flags", conntrack.TCP_SYN),
                         ("saddr", int(ipaddress.IPv4Address(
                             state.peers[j][0]))),
                         ("daddr", int(ipaddress.IPv4Address(ep_ip)))):
                batch[rows[f], 0] = np.uint32(v).view(np.int32)

            def serve() -> int:
                batch[rows["sport"], 0] = 1024 + next(sport) % 64000
                v, _e, _i, _n = run.datapath.process_packed(
                    torch.as_tensor(batch, device=dev), now=POLICY_NOW)
                return int(v[0])

            if serve() >= 0:
                raise AssertionError(f"probe {k} is allowed before its rule")
            for change in ("add", "delete"):
                t0 = time.perf_counter()
                if change == "add":
                    rev = run.policy_add(rules_from_json(
                        json.dumps(rule_dict)))
                else:
                    rev, _ = run.policy_delete(
                        LabelArray.parse(*rule_dict["labels"]))
                deadline, batches = t0 + POLICY_WAIT_S, 0
                while True:
                    batches += 1
                    verdict = serve()
                    if (verdict >= 0) == (change == "add"):
                        t_flip = time.perf_counter()
                        break
                    if time.perf_counter() > deadline:
                        raise AssertionError(
                            f"probe {k}: the {change} did not reach the "
                            f"card in {POLICY_WAIT_S} s")
                    time.sleep(0.001)
                if rev not in served or served[rev] > t_flip:
                    raise AssertionError(
                        f"probe {k}: revision {rev} flipped the flow "
                        f"before the engine reported it served")
                if not run.wait_for_policy_revision(rev, POLICY_WAIT_S):
                    raise AssertionError(f"revision {rev} not applied")
                samples.append({"change": change, "revision": rev,
                                "served_s": served[rev] - t0,
                                "flip_s": t_flip - t0,
                                "batches": batches})
    finally:
        run.shutdown()

    def pct(key, which=("add", "delete")):
        xs = [s[key] for s in samples if s["change"] in which]
        return {"p50": float(np.percentile(xs, 50)),
                "p99": float(np.percentile(xs, 99)), "samples": len(xs)}

    return {"state": dict(zip(("rules", "endpoints", "peers", "cidrs"),
                              POLICY_PROPAGATION)),
            "served_s": pct("served_s"), "flip_s": pct("flip_s"),
            "add_flip_s": pct("flip_s", ("add",)),
            "delete_flip_s": pct("flip_s", ("delete",)),
            "samples": samples}


def phase_policy(dev, pair_s: float = None,
                 function_pair_s: float = None, keep: list = None) -> int:
    """Rules to verdicts on the card; returns the dense kernel's launches
    on the path (the dense step over the rule-derived map states).  With
    the kernel's per-pair seconds (the ``sass`` phase), the kernel's
    timing carries its bound.  With ``keep``, the card's ``PolicyRun`` is
    appended to it instead of shut down (the caller shuts it down)."""
    t_phase = time.perf_counter()
    state = policy_state(*POLICY_STATE)
    remotes = policy_remotes(state)
    packed, remote = policy_packets(state, remotes, POLICY_BATCH)
    with multiprocessing.get_context("spawn").Pool(
            POLICY_WORKERS + 1) as pool:
        twin = pool.apply_async(policy_twin,
                                (state, packed, POLICY_CT_SLOTS))
        run = PolicyRun(device=dev, ct_slots=POLICY_CT_SLOTS)
        try:
            for ep_id, ip, labels in state.endpoints:
                run.endpoint_create(ep_id, ipv4=ip, labels=labels)
            for ip, labels in state.peers:
                run.add_peer(ip, labels)
            t0 = time.perf_counter()
            rev = run.policy_add(rules_from_json(state.rules_json))
            setup_s = time.perf_counter() - t0
            if not run.wait_for_policy_revision(timeout=POLICY_WAIT_S):
                raise AssertionError("policy-build: builds did not finish")
            build_s = time.perf_counter() - t0
            result = policy_card(dev, run, state, remotes, packed, remote,
                                 pool, rev, setup_s, build_s,
                                 (pair_s, function_pair_s))
            twin_res = twin.get(timeout=POLICY_WAIT_S)
        finally:
            if keep is None:
                run.shutdown()
            else:
                keep.append(run)
        twin_s = time.perf_counter() - t_phase
        result["parity"]["twin"], result["parity"]["twin_ports_renamed"] = \
            policy_twin_mismatches(result.pop("card_outputs"), twin_res,
                                   result.pop("redirects"),
                                   result.pop("map_states"))
        result["parity"]["twin_endpoints_ready"] = sum(
            s == ("ready", twin_res["revision"])
            for s in twin_res["endpoint_states"].values())
    parity = result["parity"]
    emit("policy-parity", **parity, twin_ready_s=twin_s,
         name_power_limit=nvidia_smi("name,power.limit"))
    emit("policy-timing", **result["timing"],
         name_power_limit=nvidia_smi("name,power.limit"))
    propagation = policy_propagation(dev)
    emit("policy-propagation", **propagation,
         name_power_limit=nvidia_smi("name,power.limit"))
    counts = [n for k, n in parity.items() if k.endswith("mismatches")]
    counts += list(parity["twin"].values())
    if any(counts) or parity["twin_endpoints_ready"] != len(state.endpoints):
        raise AssertionError(f"policy-parity: {parity}")
    emit("policy", seconds=time.perf_counter() - t_phase,
         hand_kernel_launches={"dense_verdict": result["launches"]},
         name_power_limit=nvidia_smi("name,power.limit"))
    return result["launches"]


def policy_card(dev, run, state, remotes, packed, remote, pool, rev,
                setup_s, build_s, pair_seconds) -> dict:
    """The card's side of ``phase_policy`` once its builds are done:
    ``policy-build``, then the batch through ``process_packed``, the
    identity, repository and map-state oracles (the repository's in
    ``pool``), the hash and dense steps over ``states_by_slot()`` and the
    timed calls."""
    n_ep = len(state.endpoints)
    endpoints = {ep.id: ep for ep in run.endpoints.endpoints()}
    ep_states = run.endpoint_states()
    ready = sum(s == ("ready", rev) for s in ep_states.values())
    if run.repo.revision != rev or ready != n_ep:
        raise AssertionError(f"policy-build: endpoints {ep_states} at "
                             f"revision {run.repo.revision}")
    for i, (ep_id, _, _) in enumerate(state.endpoints):
        if endpoints[ep_id].table_slot != i:
            raise AssertionError("endpoint slots are not in create order")
    last = {}
    for ep_id, b_rev, regen_s, sync_s in run.builds:
        if b_rev == rev:
            last[ep_id] = (regen_s, sync_s)
    regen = [r for r, _ in last.values()]
    sync = [s * 1e3 for _, s in last.values()]
    states = run.table_mgr.states_by_slot()
    entries = [len(states[s]) for s in range(n_ep)]
    emit("policy-build", rules=POLICY_STATE[0], endpoints=n_ep,
         peers=len(state.peers), cidrs=len(state.cidrs),
         identities=len(IdentityCache.snapshot(run.allocator)),
         redirects=len(run.proxy), revision=rev,
         endpoints_ready_at_revision=ready,
         import_s=setup_s, build_s=build_s, builds=len(last),
         regeneration_s={"p50": float(np.median(regen)),
                         "max": float(max(regen))},
         entries_per_endpoint={"min": min(entries),
                               "median": float(np.median(entries)),
                               "max": max(entries)},
         sync_refresh_ms={"p50": float(np.median(sync)),
                          "max": float(max(sync))},
         name_power_limit=nvidia_smi("name,power.limit"))

    # the batch on the card, and the identity oracle: the ipcache's own
    # longest match of each remote address (world when none)
    dp = run.datapath
    dp.telemetry_enabled = False
    outs = dp.process_packed(torch.as_tensor(packed, device=dev),
                             now=POLICY_NOW)
    card = policy_outputs(run, outs)
    rid = np.array([run.ipcache.lookup_longest_prefix(a) or WORLD_IDENTITY
                    for a in remotes], np.int64)
    want_id = rid[remote]
    parity = {"rows": int(packed.shape[1]),
              "identity_mismatches": int((card["identity"] != want_id)
                                         .sum()),
              "allowed_share": float((card["verdict"] >= 0).mean()),
              "redirected_share": float((card["verdict"] > 0).mean())}

    # the repository oracle on a sample, in the worker processes
    cache = IdentityCache.snapshot(run.allocator)
    labels = {ep.table_slot: tuple(str(l) for l in ep.label_array())
              for ep in endpoints.values()}
    col = {f: packed[PACKED_FIELDS.index(f)] for f in PACKED_FIELDS}
    idx = np.linspace(0, packed.shape[1] - 1, ORACLE_SAMPLE).astype(int)
    rows = [(labels[int(col["endpoint"][i])],
             tuple(str(l) for l in cache[int(want_id[i])]),
             int(col["dport"][i]), "TCP" if col["proto"][i] == 6 else "UDP",
             bool(col["direction"][i])) for i in idx]
    chunks = np.array_split(np.arange(len(rows)), POLICY_WORKERS)
    oracle = [pool.apply_async(policy_oracle, (state.rules_json,
                                               [rows[i] for i in c]))
              for c in chunks]

    # the hash step and the dense step (the CUDA kernel) over the map
    # states the rules gave, against oracle_verdict on the whole batch
    ordered = [states[s] for s in range(n_ep)]
    prefixes = run.ipcache.to_lpm_prefix_families()[0]
    step, tables, counters = make_step(
        compile_endpoints(ordered, revision=rev), compile_lpm(prefixes),
        device=dev)
    dense = dv.compile_dense(ordered, device=dev)
    segments = dv.dense_segments(dense)
    dense_lpm = dv.compile_dense_lpm(prefixes, device=dev)
    dense_pk = torch.zeros(dense.ep.shape[0], dtype=torch.int32,
                           device=dev)
    dense_by = torch.zeros_like(dense_pk)
    far = np.where(col["direction"] == 1, col["daddr"], col["saddr"])
    pk = {k: torch.as_tensor(v, device=dev) for k, v in (
        ("endpoint", col["endpoint"]), ("src_addr", far),
        ("dport", col["dport"]), ("proto", col["proto"]),
        ("direction", col["direction"]), ("length", col["length"]))}
    raw = RawPacketBatch(is_fragment=torch.zeros_like(pk["endpoint"]),
                         **pk)

    def hash_step():
        return step(tables, counters, raw)

    def dense_step():
        return dv.dense_datapath_step(
            dense, dense_lpm, dense_pk, dense_by, pk["endpoint"],
            pk["src_addr"], pk["dport"], pk["proto"], pk["direction"],
            pk["length"], segments=segments)

    dv.dense_verdict.launches = 0
    hv, hid, _ = hash_step()
    dvv, did, _, _ = dense_step()
    torch.cuda.synchronize()
    launches = dv.dense_verdict.launches
    if launches < 1:
        raise AssertionError("policy: the dense kernel was not launched")
    want_v = policy_oracle_verdicts(states, col["endpoint"], want_id,
                                    col["dport"], col["proto"],
                                    col["direction"])
    hv, hid = hv.cpu().numpy(), hid.cpu().numpy()
    dvv, did = dvv.cpu().numpy(), did.cpu().numpy()
    parity.update(
        hash_oracle_mismatches=int((hv != want_v).sum()),
        dense_oracle_mismatches=int((dvv != want_v).sum()),
        hash_identity_mismatches=int((hid != want_id).sum()),
        dense_identity_mismatches=int((did != want_id).sum()),
        serving_vs_map_state_mismatches=int((card["verdict"] != want_v)
                                            .sum()))

    # timing: process_packed over fresh batches, the two steps, the kernel
    batches = [torch.as_tensor(policy_packets(state, remotes, POLICY_BATCH,
                                              seed=13 + k)[0], device=dev)
               for k in range(POLICY_CYCLE)]
    turn = iter(range(1 << 30))
    serve_ms = cuda_ms(lambda: dp.process_packed(
        batches[next(turn) % POLICY_CYCLE], now=POLICY_NOW + 1),
        POLICY_TIMED)
    args = (pk["endpoint"], torch.as_tensor(did, device=dev), pk["dport"],
            pk["proto"], pk["direction"], pk["length"])
    timed = {"process_packed": timing(serve_ms, POLICY_BATCH),
             "hash_step": timing(cuda_ms(hash_step, POLICY_TIMED),
                                 POLICY_BATCH),
             "dense_step": timing(cuda_ms(dense_step, POLICY_TIMED),
                                  POLICY_BATCH),
             "dense_kernel": timing(cuda_ms(lambda: dv.dense_verdict(
                 dense, *args, segments=segments), POLICY_TIMED),
                 POLICY_BATCH)}
    timed["dense_kernel"]["path_launches"] = launches
    if pair_seconds[0] is not None:
        timed["dense_kernel"].update(dense_bound_ms(
            dense, pk["endpoint"], *pair_seconds))
    timed["entries"] = int(dense.ep.shape[0])
    timed["ct_entries"] = dp.ct_entries()

    # the repository oracle's verdicts
    # an allowed row forwards (0) or, where its redirect covers it, takes
    # the redirect's proxy port; a denied row drops.  A row that
    # allows_* denies while the endpoint's own L4 policy covers it
    # (fromRequires with an L3-only rule beside an L7 filter: ROADMAP.md
    # section 3) is counted apart, and its verdict must be the one that
    # policy gives, as the reference's map state gives it
    decided = [d for res in oracle for d in res.get(timeout=POLICY_WAIT_S)]
    bad = redirected = divergent = 0
    for i, (allowed, covered, redir) in zip(idx, decided):
        v = int(card["verdict"][i])
        divergent += covered and not allowed
        if redir:
            redirected += 1
            want = run.proxy.get(proxy_id(
                state.endpoints[int(col["endpoint"][i])][0],
                not col["direction"][i],
                "TCP" if col["proto"][i] == 6 else "UDP",
                int(col["dport"][i]))).proxy_port
            bad += v != want
        else:
            bad += v != 0 if allowed or covered else v >= 0
    parity.update(repository_sample=len(idx),
                  repository_redirected=redirected,
                  repository_mismatches=int(bad),
                  repository_denied_but_covered=int(divergent))
    return {"parity": parity, "timing": timed, "launches": launches,
            "card_outputs": card, "map_states": policy_map_states(run),
            "redirects": {r.id: r.proxy_port for r in run.proxy.redirects()}}

AGENT_STATE_ROOT = kernels.BUILD_DIR
DAEMON_TIMED = 50
DAEMON_REST_CALLS = 20
DAEMON_HOST_SAMPLE = 4096


def rest(url: str, method: str, path: str, body=None):
    """(HTTP status, decoded JSON) of one request to the agent's API."""
    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(url + path, data=data, method=method)
    with urllib.request.urlopen(req, timeout=POLICY_WAIT_S) as resp:
        return resp.status, json.loads(resp.read())


def start_agent(dev, state_dir: str, ct_slots: int = POLICY_CT_SLOTS):
    """(Daemon, APIServer on port 0, seconds to both up) on ``dev``, by
    default with the conntrack geometry of ``phase_policy``'s run."""
    t0 = time.perf_counter()
    d = Daemon(config=DaemonConfig(state_dir=state_dir,
                                   ct_slots=ct_slots), device=dev)
    try:
        srv = APIServer(d).start()
    except BaseException:
        d.shutdown()
        raise
    return d, srv, time.perf_counter() - t0


def agent_settled(d, timeout: float) -> bool:
    """Every endpoint at the repository's revision, the build queue idle
    and the engine's LPM holding the ipcache's prefixes."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if d.wait_for_policy_revision(timeout=1.0) and \
                d.datapath.ipcache_prefixes == \
                d.ipcache.to_lpm_prefix_families()[0]:
            return True
    return False


def host_path_mismatches(d, state, packed, identity) -> int:
    """``HostVerdictPath`` (the C++ verdict caches) against the card's
    live policy tables (``policy_replay``) on a sample of the batch's
    rows, each with the identity the card resolved for it."""
    col = {f: packed[PACKED_FIELDS.index(f)] for f in PACKED_FIELDS}
    idx = np.linspace(0, packed.shape[1] - 1, DAEMON_HOST_SAMPLE).astype(int)
    slots, ids = col["endpoint"][idx], identity[idx]
    dports, protos = col["dport"][idx], col["proto"][idx]
    dirs = col["direction"][idx]
    card = np.array([r["verdict"] for r in d.datapath.policy_replay(
        slots, ids, dports, protos, dirs)], np.int32)
    bad = 0
    for slot in np.unique(slots).tolist():
        m = slots == slot
        host = d.host_path.classify(state.endpoints[slot][0], ids[m],
                                    dports[m], protos[m], dirs[m])
        bad += int((host != card[m]).sum())
    return bad


def ct_established(outputs, packed) -> np.ndarray:
    """[B] bool: the rows whose flow has an entry in the conntrack table
    ``outputs`` holds (``policy_outputs``'s ``ct.*`` fields).  No service
    is loaded, so a row's key is its own 5-tuple and direction
    (``pipeline.full_datapath_step``'s ``CTBatch``).  A new flow that
    loses both of the step's claim rounds gets no entry."""
    col = {f: packed[PACKED_FIELDS.index(f)].astype(np.int64)
           for f in PACKED_FIELDS}

    def keys(*words):
        arr = np.stack([np.asarray(w, np.int64).astype(np.uint32)
                        for w in words], 1)
        return np.ascontiguousarray(arr).view(
            np.dtype((np.void, 16))).ravel()

    live = outputs["ct.k3"][:-1] != 0
    table = keys(*(outputs[f"ct.k{i}"][:-1][live] for i in range(4)))
    rows = keys(col["saddr"], col["daddr"],
                ((col["sport"] & 0xFFFF) << 16) | (col["dport"] & 0xFFFF),
                ((col["proto"] & 0xFF) << 8) | ((col["direction"] & 1) << 1)
                | 1)
    return np.isin(rows, table)


def phase_daemon(dev, run) -> int:
    """The single-node agent on the card; returns the dense kernel's
    launches on its path.  ``run`` is ``phase_policy``'s ``PolicyRun``:
    its map states, redirects and engine are what the agent is held
    against."""
    t_phase = time.perf_counter()
    state = policy_state(*POLICY_STATE)
    remotes = policy_remotes(state)
    packed, _ = policy_packets(state, remotes, POLICY_BATCH)
    # the agent's state directory lives in the checkout's build directory
    AGENT_STATE_ROOT.mkdir(parents=True, exist_ok=True)
    state_dir = tempfile.mkdtemp(prefix="agent-state-",
                                 dir=AGENT_STATE_ROOT)
    dv.dense_verdict.launches = 0
    d = srv = None
    try:
        d, srv, start_s = start_agent(dev, state_dir)
        url = srv.base_url
        t_import = time.perf_counter()
        for ep_id, ip, labels in state.endpoints:
            rest(url, "PUT", f"/endpoint/{ep_id}",
                 {"ipv4": ip, "labels": list(labels)})
        # remote workloads as the kvstore watchers enter them
        for ip, labels in state.peers:
            ident, _ = d.identity_allocator.allocate(
                Labels.from_model(list(labels)))
            d.ipcache.upsert(ip, ident.id, SOURCE_KVSTORE)
        _, imported = rest(url, "PUT", "/policy", state.rules_json.encode())
        rev = imported["revision"]
        if not agent_settled(d, POLICY_WAIT_S):
            raise AssertionError("daemon: builds did not finish")
        ready_s = time.perf_counter() - t_import
        ready = sum((ep.state, ep.policy_revision) == ("ready", rev)
                    for ep in d.endpoints.endpoints())
        emit("daemon-start", endpoints=len(state.endpoints),
             endpoints_ready_at_revision=ready, revision=rev,
             redirects=len(d.proxy),
             identities=len(d.identity_allocator),
             agent_start_s=start_s, import_to_ready_s=ready_s,
             name_power_limit=nvidia_smi("name,power.limit"))

        # the same batch through the agent and phase_policy's run, at the
        # current time (the ct-gc controller keeps every entry), both
        # from an empty conntrack table and zeroed counters
        now = int(time.time())
        run.datapath.restore_ct_snapshots(*d.datapath.snapshot_ct())
        zeroed = run.datapath.counters
        zeroed.packets.zero_()
        zeroed.bytes.zero_()
        batch = torch.as_tensor(packed, device=dev)
        want = policy_outputs(run, run.datapath.process_packed(batch,
                                                               now=now))
        got = policy_outputs(d, d.datapath.process_packed(batch, now=now))
        parity, renamed = policy_twin_mismatches(
            want, {"outputs": got,
                   "redirects": {r.id: r.proxy_port
                                 for r in d.proxy.redirects()},
                   "states": policy_map_states(d)},
            {r.id: r.proxy_port for r in run.proxy.redirects()},
            policy_map_states(run))
        _, audit = rest(url, "POST", "/debug/drift-audit")
        if d.host_path is None:
            raise AssertionError("daemon: the host fast path did not build")
        host_bad = host_path_mismatches(d, state, packed, got["identity"])
        emit("daemon-parity", rows=int(packed.shape[1]),
             vs_policy_run=parity, ports_renamed=renamed,
             allowed_share=float((got["verdict"] >= 0).mean()),
             redirected_share=float((got["verdict"] > 0).mean()),
             drift_audit={"status": audit["status"],
                          "checked": audit["checked"],
                          "sc_checked": audit["sc-checked"],
                          "divergences": len(audit["divergences"])},
             host_path_rows=DAEMON_HOST_SAMPLE,
             host_path_mismatches=host_bad,
             name_power_limit=nvidia_smi("name,power.limit"))

        # timing: process_packed over fresh batches, then REST round trips
        batches = [torch.as_tensor(policy_packets(
            state, remotes, POLICY_BATCH, seed=13 + k)[0], device=dev)
            for k in range(POLICY_CYCLE)]
        turn = iter(range(1 << 30))
        serve_ms = cuda_ms(lambda: d.datapath.process_packed(
            batches[next(turn) % POLICY_CYCLE], now=now), DAEMON_TIMED)
        health, policy = [], []
        for _ in range(DAEMON_REST_CALLS):
            for path, out in (("/healthz", health), ("/policy", policy)):
                t0 = time.perf_counter()
                rest(url, "GET", path)
                out.append(time.perf_counter() - t0)
        emit("daemon-timing",
             process_packed=timing(serve_ms, POLICY_BATCH),
             healthz_ms={"p50": float(np.median(health)) * 1e3,
                         "samples": len(health)},
             get_policy_ms={"p50": float(np.median(policy)) * 1e3,
                            "samples": len(policy)},
             name_power_limit=nvidia_smi("name,power.limit"))

        # the CLI against the agent: status, and a replay trace of an
        # allowed row through the live tables
        col = {f: packed[PACKED_FIELDS.index(f)] for f in PACKED_FIELDS}
        i = int(np.flatnonzero(got["verdict"] == 0)[0])
        trace = ["policy", "trace", "--replay", "--endpoint",
                 str(state.endpoints[int(col["endpoint"][i])][0]),
                 "--identity", str(int(got["identity"][i])),
                 "--dport", str(int(col["dport"][i])),
                 "--proto", str(int(col["proto"][i])), "--direction",
                 "egress" if col["direction"][i] else "ingress"]
        with contextlib.redirect_stdout(io.StringIO()) as cli_out:
            cli_rc = {"status": cli_main(["--api", url, "status"]),
                      "policy trace": cli_main(["--api", url, *trace])}
        emit("daemon-cli", exit_codes=cli_rc,
             status_lines=len(cli_out.getvalue().splitlines()))

        # restart: checkpoint, shut down, a new agent on the state dir
        ct_before = d.datapath.ct_entries()
        t0 = time.perf_counter()
        if not d.checkpoint_ct():
            raise AssertionError("daemon: checkpoint_ct failed")
        checkpoint_s = time.perf_counter() - t0
        srv.shutdown()
        d.shutdown()
        d = srv = None
        t_restart = time.perf_counter()
        d, srv, _ = start_agent(dev, state_dir)
        restored = d.restore_endpoints()
        ct_after = d.datapath.ct_entries()
        again = d.datapath.process_packed(batch, now=now)[0].cpu().numpy()
        restart_s = time.perf_counter() - t_restart
        established = ct_established(got, packed)
        kept = int((again[established] !=
                    got["verdict"][established]).sum()) + \
            int((got["verdict"][established] < 0).sum())
        emit("daemon-restart", endpoints_restored=restored,
             ct_entries_before=list(ct_before),
             ct_entries_restored=list(ct_after),
             established_rows=int(established.sum()),
             established_mismatches=kept,
             restart_to_serving_s=restart_s, checkpoint_ct_s=checkpoint_s,
             name_power_limit=nvidia_smi("name,power.limit"))
    finally:
        if srv is not None:
            srv.shutdown()
        if d is not None:
            d.shutdown()
        shutil.rmtree(state_dir, ignore_errors=True)
    launches = dv.dense_verdict.launches
    counts = list(parity.values()) + [
        len(audit["divergences"]), host_bad, kept,
        int(audit["status"] != "ok"), *cli_rc.values(),
        int(ready != len(state.endpoints)),
        int(restored != len(state.endpoints)),
        int(tuple(ct_after) != tuple(ct_before))]
    if any(counts):
        raise AssertionError(f"daemon: {counts}")
    emit("daemon", seconds=time.perf_counter() - t_phase,
         hand_kernel_launches={"dense_verdict": launches},
         name_power_limit=nvidia_smi("name,power.limit"))
    return launches


# the kvstore phase: the propagation state (it builds cheaply); a
# cluster id, so every identity the store hands out is above 2**16
KVSTORE_STATE = POLICY_PROPAGATION
KVSTORE_BATCH = 1 << 20
KVSTORE_HELD = 1 << 16
KVSTORE_CLUSTER_ID = 3
KVSTORE_NODE_B = ("node-b", "192.168.77.2", "10.129.0.0/24")
KVSTORE_OUTAGE_LABEL = "k8s:outage=held"
KVSTORE_WAIT_S = 120.0


def kvstore_agent(dev, backend, node: str, survive: bool = False):
    """A ``Daemon`` on ``dev`` over ``backend`` (None: no kvstore), with
    the conntrack geometry of ``phase_policy``'s run; ``survive`` turns
    on the outage guard's degrade, journal and promotion, with the
    chaos tests' probe cadence."""
    cfg = DaemonConfig(state_dir="", ct_slots=POLICY_CT_SLOTS,
                       cluster_id=KVSTORE_CLUSTER_ID,
                       enable_kvstore_survival=survive,
                       kvstore_probe_interval_s=0.1,
                       kvstore_failure_threshold=2)
    return Daemon(config=cfg, kvstore_backend=backend, node_name=node,
                  device=dev)


def wait_until(cond, what: str, timeout: float = KVSTORE_WAIT_S) -> float:
    """Seconds until ``cond()`` holds; raises past ``timeout``."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"kvstore: timed out waiting for {what}")
        time.sleep(0.005)
    return time.perf_counter() - t0


def card_lpm(dp, table: str, addrs) -> np.ndarray:
    """The values the engine's device LPM (``ipcache`` or ``tunnel``)
    gives ``addrs`` (dotted IPv4), LPM_MISS where none matches: a lookup
    on the tensors the served step reads."""
    t = dp._tables
    if table == "ipcache":
        lpm, compiled = t.datapath, dp.compiled_ipcache
        tensors = (lpm.lpm_masks, lpm.lpm_key_a, lpm.lpm_key_b,
                   lpm.lpm_value, lpm.lpm_plens)
    else:
        compiled = dp.compiled_tunnel
        if compiled is None or t.tun_masks is None:
            return np.full(len(addrs), LPM_MISS, np.int32)
        tensors = (t.tun_masks, t.tun_key_a, t.tun_key_b, t.tun_value,
                   t.tun_plens)
    keys = torch.as_tensor(np.array([int(ipaddress.IPv4Address(a))
                                     for a in addrs], np.uint32)
                           .view(np.int32), device=dp.device)
    _found, value = lpm_lookup(*tensors, keys,
                               max(1, compiled.max_probe))
    return value.cpu().numpy()


def identity_rename(src, dst) -> dict:
    """{numeric identity on ``src``: the one ``dst`` gives its labels},
    for every identity ``src`` knows that ``dst`` knows too."""
    out = {}
    for ident in src.identity_allocator.snapshot_identities():
        other = dst.identity_allocator.lookup_by_labels(ident.labels)
        if other is not None:
            out[ident.id] = other.id
    return out


def rename_ids(arr, rename: dict) -> np.ndarray:
    """``arr``'s identities renamed through ``rename``."""
    arr = np.asarray(arr)
    u, inv = np.unique(arr, return_inverse=True)
    mapped = np.array([rename.get(int(x), int(x)) for x in u], arr.dtype)
    return mapped[inv].reshape(arr.shape)


def map_state_diff(a, r, rename: dict) -> list:
    """The map-state entries in which agent ``a`` and agent ``r``
    differ, endpoint by endpoint id: ``a``'s identities renamed through
    ``rename`` and its proxy ports to ``r``'s through the redirect ids;
    each as {endpoint, key (identity, port, proto, direction), the
    agent that holds it, its proxy port, the endpoint's identity and
    policy revision there}."""
    redirect_of = {x.proxy_port: x.id for x in a.proxy.redirects()}
    port_in_r = {x.id: x.proxy_port for x in r.proxy.redirects()}
    by_slot = [policy_map_states(a, rename), policy_map_states(r)]
    out = []
    for ep in sorted({e.id for e in a.endpoints.endpoints()} |
                     {e.id for e in r.endpoints.endpoints()}):
        eps = [d.endpoints.lookup(ep) for d in (a, r)]
        got = [by_slot[k].get(getattr(e, "table_slot", None), {})
               for k, e in enumerate(eps)]
        renamed = {(key, port_in_r.get(redirect_of.get(v), v) if v else 0)
                   for key, v in got[0].items()}
        for which, (key, port) in sorted(
                [("a", x) for x in renamed - set(got[1].items())] +
                [("r", x) for x in set(got[1].items()) - renamed]):
            e = eps[0 if which == "a" else 1]
            out.append({"endpoint": ep, "key": list(key), "in": which,
                        "proxy_port": port,
                        "endpoint_identity": getattr(
                            e, "security_identity", None),
                        "policy_revision": getattr(
                            e, "policy_revision", None)})
    return out


def map_state_gap(a, r, rename: dict) -> int:
    """How many map-state entries ``map_state_diff`` finds."""
    return len(map_state_diff(a, r, rename))


def kvstore_converged(a, r, timeout: float = KVSTORE_WAIT_S):
    """Seconds until ``a`` and ``r`` are idle with equal map states up
    to renaming and their engines' LPMs hold their ipcaches (identity
    changes regenerate without a revision bump, so the revision wait
    alone does not see them); None if that does not happen within
    ``timeout``, and the parity legs then count the differences."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if all(d.wait_for_quiesce(1.0) and d.datapath.ipcache_prefixes ==
               d.ipcache.to_lpm_prefix_families()[0] for d in (a, r)) \
                and map_state_gap(a, r, identity_rename(a, r)) == 0:
            return time.perf_counter() - t0
        time.sleep(0.01)
    return None


def outage_packets(state, remotes, slot: int, ip: str, seed: int):
    """``policy_packets`` rows moved onto the endpoint in table slot
    ``slot`` with address ``ip``: new connections to and from the
    remotes, half ingress and half egress."""
    packed, _ = policy_packets(state, remotes, KVSTORE_HELD, seed=seed)
    col = {f: i for i, f in enumerate(PACKED_FIELDS)}
    egress = packed[col["direction"]] == 1
    addr = np.uint32(int(ipaddress.IPv4Address(ip))).view(np.int32)
    packed[col["endpoint"]] = slot
    packed[col["saddr"]] = np.where(egress, addr, packed[col["saddr"]])
    packed[col["daddr"]] = np.where(egress, packed[col["daddr"]], addr)
    return packed


def phase_kvstore(dev) -> int:
    """Two agents on the card joined through the port's kvstore, held
    against an agent that is given the peers by hand; returns the dense
    kernel's launches on the path (the agents serve on the hash
    engine)."""
    t_phase = time.perf_counter()
    state = policy_state(*KVSTORE_STATE)
    remotes = policy_remotes(state)
    packed, _ = policy_packets(state, remotes, KVSTORE_BATCH)
    held, _ = policy_packets(state, remotes, KVSTORE_HELD, seed=21)
    node_b, node_b_ip, pod_cidr = KVSTORE_NODE_B
    etcd = MiniEtcd(reap_interval=0.1).start()
    proxy = FaultProxy("127.0.0.1", etcd.port).start()
    injector = ControlPlaneFaultInjector(etcd=proxy,
                                         lease_expirer=etcd.expire_leases)
    agents, srv = [], None
    dv.dense_verdict.launches = 0
    try:
        # A behind the fault proxy, B straight on the store, R without
        # a store; the rules reach A over REST, R directly
        a = kvstore_agent(dev, EtcdBackend(
            host="127.0.0.1", port=proxy.port, lease_ttl=30.0,
            timeout=1.0), "node-a", survive=True)
        agents.append(a)
        b = kvstore_agent(dev, EtcdBackend(port=etcd.port, lease_ttl=30.0),
                          node_b)
        agents.append(b)
        r = kvstore_agent(dev, None, "node-r")
        agents.append(r)
        srv = APIServer(a).start()
        url = srv.base_url
        for ep_id, ip, labels in state.endpoints:
            rest(url, "PUT", f"/endpoint/{ep_id}",
                 {"ipv4": ip, "labels": list(labels)})
            r.endpoint_create(ep_id, ipv4=ip, labels=list(labels))
        # R's peers as phase_daemon enters them, before its rules
        for ip, labels in state.peers:
            ident, _ = r.identity_allocator.allocate(
                Labels.from_model(list(labels)))
            r.ipcache.upsert(ip, ident.id, SOURCE_KVSTORE)
        rest(url, "PUT", "/policy", state.rules_json.encode())
        r.policy_add(rules_from_json(state.rules_json))
        r.node_manager.node_updated(Node(
            name=node_b, cluster=r.config.cluster_name,
            cluster_id=KVSTORE_CLUSTER_ID,
            addresses=[NodeAddress(type="InternalIP", ip=node_b_ip)],
            ipv4_alloc_cidr=pod_cidr))
        if not (agent_settled(a, POLICY_WAIT_S) and
                agent_settled(r, POLICY_WAIT_S)):
            raise AssertionError("kvstore: builds did not finish")

        # ---- kvstore-converge: B's workloads reach A's card ----
        peer_ips = [ip for ip, _ in state.peers]
        t0 = time.perf_counter()
        for k, (ip, labels) in enumerate(state.peers):
            b.endpoint_create(3000 + k, ipv4=ip, labels=list(labels))
        b.register_node(node_b_ip, pod_cidr)

        def peers_on_card():
            want = [b.identity_allocator.lookup_by_labels(
                Labels.from_model(list(labels))).id
                for _ip, labels in state.peers]
            return (card_lpm(a.datapath, "ipcache", peer_ips) ==
                    np.array(want, np.int32)).all()
        wait_until(peers_on_card, "the peers in A's card ipcache")
        converge_s = time.perf_counter() - t0
        def tunnel_on_card():
            return bool(card_lpm(
                a.datapath, "tunnel",
                [str(ipaddress.ip_network(pod_cidr)[7])])[0] ==
                np.uint32(int(ipaddress.IPv4Address(node_b_ip)))
                .view(np.int32))
        tunnel_s = wait_until(tunnel_on_card,
                              "B's pod CIDR in A's card tunnel LPM")
        # read again after the wait: what is reported is a lookup
        tunnel_in = tunnel_on_card()
        policy_s = kvstore_converged(a, r)
        label_sets = {tuple(lb) for _e, _ip, lb in state.endpoints} | \
            {tuple(lb) for _ip, lb in state.peers}
        ids_a, ids_b = ({lb: d.identity_allocator.lookup_by_labels(
            Labels.from_model(list(lb))).id for lb in label_sets}
            for d in (a, b))
        emit("kvstore-converge", peers=len(peer_ips),
             peers_on_card_s=converge_s,
             tunnel_on_card_s=converge_s + tunnel_s,
             policy_converged_s=policy_s,
             label_sets=len(label_sets),
             identities_equal_a_b=sum(ids_a[k] == ids_b[k]
                                      for k in label_sets),
             identities_above_2_16=sum(i >> 16 == KVSTORE_CLUSTER_ID
                                       for i in ids_a.values()),
             pod_cidr_in_card_tunnel=tunnel_in,
             name_power_limit=nvidia_smi("name,power.limit"))

        # ---- kvstore-parity: A against R, renamed by labels ----
        now = int(time.time())
        batch = torch.as_tensor(packed, device=dev)
        for d in (a, r):
            d.datapath.counters.packets.zero_()
            d.datapath.counters.bytes.zero_()
        rename = identity_rename(a, r)
        got = policy_outputs(a, a.datapath.process_packed(batch, now=now),
                             rename=rename)
        want = policy_outputs(r, r.datapath.process_packed(batch, now=now))
        parity, ports_renamed = policy_twin_mismatches(
            got, {"outputs": want,
                  "redirects": {x.id: x.proxy_port
                                for x in r.proxy.redirects()},
                  "states": policy_map_states(r)},
            {x.id: x.proxy_port for x in a.proxy.redirects()},
            policy_map_states(a, rename))
        emit("kvstore-parity", rows=int(packed.shape[1]),
             a_vs_r=parity, ports_renamed=ports_renamed,
             identities_renamed=sum(k != v for k, v in rename.items()),
             allowed_share=float((got["verdict"] >= 0).mean()),
             name_power_limit=nvidia_smi("name,power.limit"))

        # ---- kvstore-outage: blackhole, an endpoint, heal ----
        held_t = torch.as_tensor(held, device=dev)
        snap = a.datapath.snapshot_ct()
        before = policy_outputs(a, a.datapath.process_packed(held_t,
                                                             now=now))
        seq0 = a.flight_events()["seq"]
        injector.blackhole("etcd")
        degrade_s = wait_until(
            lambda: a.status()["kvstore"]["mode"] == "degraded",
            "A degraded")
        a.datapath.restore_ct_snapshots(*snap)
        during = policy_outputs(a, a.datapath.process_packed(held_t,
                                                             now=now))
        held_bad = {k: int((during[k] != before[k]).sum())
                    for k in before if not k.startswith("counters.")}
        new_id = POLICY_ENDPOINT_ID_BASE + len(state.endpoints)
        new_ip = "10.130.0.2"
        new_labels = list(state.endpoints[0][2]) + [KVSTORE_OUTAGE_LABEL]
        rest(url, "PUT", f"/endpoint/{new_id}",
             {"ipv4": new_ip, "labels": new_labels})
        local_id = a.endpoints.lookup(new_id).security_identity
        # R has no identity watch: its other endpoints learn the new
        # identity when told, as A's learn it from the allocator
        r.endpoint_create(new_id, ipv4=new_ip, labels=new_labels)
        r.trigger_policy_updates("identity-change")
        t0 = time.perf_counter()
        injector.heal()
        wait_until(lambda: a.status()["kvstore"]["mode"] == "ok" and
                   a.status()["kvstore"]["local-identities"] == 0,
                   "A recovered with its identities promoted")
        recover_s = time.perf_counter() - t0
        promoted_id = a.endpoints.lookup(new_id).security_identity
        promoted_s = kvstore_converged(a, r)
        seen = {e["type"] for e in a.flight_events(since=seq0)["events"]}
        notes = [e.note for e in a.monitor.tail(1000, kind="agent")
                 if e.note.startswith("identity-promotion")]
        promoted = sum(int(n.split("promoted=")[1].split()[0])
                       for n in notes)
        slot_a = a.endpoints.lookup(new_id).table_slot
        slot_r = r.endpoints.lookup(new_id).table_slot
        rename = identity_rename(a, r)
        pk_a = outage_packets(state, remotes, slot_a, new_ip, seed=23)
        pk_r = outage_packets(state, remotes, slot_r, new_ip, seed=23)
        out_a = a.datapath.process_packed(torch.as_tensor(pk_a, device=dev),
                                          now=now)
        out_r = r.datapath.process_packed(torch.as_tensor(pk_r, device=dev),
                                          now=now)
        new_bad = {
            "verdict": int((out_a[0].cpu().numpy() !=
                            out_r[0].cpu().numpy()).sum()),
            "event": int((out_a[1].cpu().numpy() !=
                          out_r[1].cpu().numpy()).sum()),
            "identity": int((rename_ids(out_a[2].cpu().numpy(), rename) !=
                             out_r[2].cpu().numpy()).sum())}
        diff = map_state_diff(a, r, rename)
        new_bad["map_state"] = len(diff)
        if diff:
            # what the promotion left apart, for the open fault of
            # ROADMAP §3: the entries, and each side's identities
            emit("kvstore-outage-diff", entries=diff[:64],
                 local_id=local_id, promoted_id=promoted_id,
                 rename={str(k): v for k, v in rename.items() if k != v},
                 a_revision=a.repo.revision, r_revision=r.repo.revision)
        events_needed = {"kvstore-degraded", "kvstore-reconciling",
                         "kvstore-recovered"}
        emit("kvstore-outage", held_rows=int(held.shape[1]),
             degraded_s=degrade_s, held_mismatches=held_bad,
             outage_identity=local_id,
             outage_identity_local=is_local_scope_identity(local_id),
             recovered_s=recover_s, promoted=promoted,
             policy_converged_s=promoted_s,
             promoted_identity=promoted_id,
             events_seen=sorted(seen & events_needed),
             new_endpoint_rows=int(pk_a.shape[1]),
             new_endpoint_vs_r=new_bad,
             allowed_share=float((out_a[0].cpu().numpy() >= 0).mean()),
             name_power_limit=nvidia_smi("name,power.limit"))
    finally:
        if srv is not None:
            srv.shutdown()
        for d in agents:
            d.shutdown()
        injector.close()
        proxy.close()
        etcd.shutdown()
    launches = dv.dense_verdict.launches
    counts = list(parity.values()) + list(held_bad.values()) + \
        list(new_bad.values()) + [
            len(label_sets) - sum(ids_a[k] == ids_b[k] for k in label_sets),
            int(not tunnel_in), int(not is_local_scope_identity(local_id)),
            int(is_local_scope_identity(promoted_id)), int(promoted < 1),
            len(events_needed - seen)]
    if any(counts):
        raise AssertionError(f"kvstore: {counts}")
    emit("kvstore", seconds=time.perf_counter() - t_phase,
         hand_kernel_launches={"dense_verdict": launches},
         name_power_limit=nvidia_smi("name,power.limit"))
    return launches


# ---------------------------------------------------------------------------
# phase 14: the sharded dataplane
# ---------------------------------------------------------------------------

SHARDS = 4
SHARDED_CT_SLOTS = 1 << 20          # per shard
SHARDED_BATCH = 1 << 20
SHARDED_TWIN = 1 << 16
SHARDED_KILL = 1 << 14              # pool records of each kill-leg chunk
SHARDED_VICTIM = 1
SHARDED_TIMED = {1 << 15: 20, 1 << 20: 5}
SHARDED_AGENT_BATCH = 1 << 16
SHARDED_WAIT_S = 60.0
DFA_ROWS = 4096
DFA_LEN = 1024
DFA_CHUNK_BYTES = 4 << 30           # a chunk's [B, L/N, S] functions
DFA_TIMED = 5


def shard_rows(packed: np.ndarray, n: int):
    """(row index, [10, rows] sub-batch with shard-local endpoint slots)
    for each shard: ``ShardedServingLane``'s split (``endpoint % n``,
    local slot ``endpoint // n``)."""
    ep_row = PACKED_FIELDS.index("endpoint")
    out = []
    for k in range(n):
        idx = np.flatnonzero(packed[ep_row] % n == k)
        sub = np.ascontiguousarray(packed[:, idx])
        sub[ep_row] //= n
        out.append((idx, sub))
    return out


def soa_of(packed: np.ndarray) -> dict:
    return {f: np.ascontiguousarray(packed[i])
            for i, f in enumerate(PACKED_FIELDS)}


def cross_shard_rows(packed: np.ndarray, n: int) -> np.ndarray:
    """Rows whose 5-tuple, either way round, is also carried on an
    endpoint of another shard in ``packed``: established in one shard's
    CT and new in the other's (the CT key has no endpoint)."""
    f = {name: packed[i].astype(np.int64) & 0xFFFFFFFF
         for i, name in enumerate(PACKED_FIELDS)}
    a = (f["saddr"] << 16) | f["sport"]
    b = (f["daddr"] << 16) | f["dport"]
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    keys = np.stack([lo, hi, f["proto"]], axis=1)
    _, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    owner = f["endpoint"] % n
    first = np.full(inv.max() + 1 if inv.size else 0, -1, np.int64)
    first[inv[::-1]] = owner[::-1]
    mixed = np.zeros(first.shape[0], bool)
    np.logical_or.at(mixed, inv, owner != first[inv])
    return mixed[inv]


def balanced_batch(state4, per_shard: int, n: int, seed: int) -> np.ndarray:
    """[10, per_shard * n] rows of the v4 pool, in pool order, exactly
    ``per_shard`` on each shard: with a power of two on every lane and on
    the single engine's, no lane pads its batch (pad rows repeat a
    record and count it again in the per-entry counters)."""
    packed = next(v4_serving_packets(state4, per_shard * n * 5 // 4,
                                     n_flows=V4_FLOWS, seed=seed))
    owner = packed[PACKED_FIELDS.index("endpoint")] % n
    keep = np.zeros(packed.shape[1], bool)
    for k in range(n):
        idx = np.flatnonzero(owner == k)
        if idx.size < per_shard:
            raise AssertionError(f"sharded: {idx.size} rows for shard {k}")
        keep[idx[:per_shard]] = True
    return np.ascontiguousarray(packed[:, keep])


def ct_live_keys(dp) -> dict:
    """{(k0, k1, k2, k3): slot} of the live keys of an engine's v4 CT."""
    st = dp.ct.state[:4, :dp.ct.slots].cpu().numpy()
    live = np.flatnonzero(st[3] != 0)
    return dict(zip(map(tuple, st[:, live].T.tolist()), live.tolist()))


def race_lost(dps, missing) -> int:
    """How many of ``missing`` (CT keys another plane created from the
    same rows) lost a same-batch slot race in the engines ``dps``: from
    an empty table a create's first choice is its window's first slot,
    and one create wins a slot a round (two rounds), so a key that lost
    finds that slot held by another key of the batch.  Keys missing for
    any other reason are not counted."""
    if not missing:
        return 0
    keys = torch.as_tensor(np.array(sorted(missing), np.int32))
    lost = np.zeros(keys.shape[0], bool)
    for dp in dps:
        ct = dp.ct
        k = keys.to(ct.state.device)
        first = conntrack._probe_idx(k[:, 0], k[:, 1], k[:, 2], k[:, 3],
                                     ct.slots, ct.max_probe)[:, 0].long()
        held = ct.state[:4, first].T
        lost |= ((held[:, 3] != 0) & (held != k).any(dim=1)).cpu().numpy()
    return int(lost.sum())


def entry_counters(tables, counters, n: int, k: int) -> dict:
    """{(global endpoint slot, key id, key meta): (packets, bytes)} of an
    engine's nonzero per-entry counters; shard ``k`` of ``n`` (one
    engine: 0 of 1)."""
    meta = tables.key_meta.cpu().numpy()
    kid = tables.key_id.cpu().numpy()
    slots = meta.shape[1]
    pk = counters.packets.cpu().numpy()
    by = counters.bytes.cpu().numpy()
    out = {}
    for i in np.flatnonzero(pk).tolist():
        e, s = divmod(i, slots)
        out[(e * n + k, int(kid[e, s]), int(meta[e, s]))] = (int(pk[i]),
                                                              int(by[i]))
    return out


def sharded_twin(plane, cpu_plane, packed: np.ndarray, now: int) -> dict:
    """The same rows through every shard's ``process_packed`` on the card
    and on the CPU at one clock: mismatches in every output, provenance,
    CT field (``mismatches``' slots), counter and flow-table lane."""
    bad = {}

    def add(name, x, y):
        x, y = np.asarray(x), np.asarray(y)
        bad[name] = bad.get(name, 0) + (int((x != y).sum())
                                        if x.shape == y.shape else -1)
    for k, (idx, sub) in enumerate(shard_rows(packed, plane.n_shards)):
        g, c = plane.shards[k], cpu_plane.shards[k]
        if idx.size:
            outs_g = g.process_packed(torch.as_tensor(sub, device=g.device),
                                      now=now)
            outs_c = c.process_packed(torch.as_tensor(sub), now=now)
            for name, x, y in zip(("verdict", "event", "identity"),
                                  outs_g[:3], outs_c[:3]):
                add(name, x.cpu(), y)
            for name, x, y in zip(outs_g[3]._fields, outs_g[3], outs_c[3]):
                add(f"nat.{name}", x.cpu(), y)
            for name, x, y in zip(("match_slot", "tier"),
                                  g.last_provenance, c.last_provenance):
                add(f"provenance.{name}", x.cpu(), y)
        # the sentinel included, the discard slot (where losing and
        # masked writes land, in any order on the card) left out
        n = g.ct.slots + 1
        for i, name in enumerate(conntrack.FIELDS):
            add(f"ct.{name}", g.ct.state[i, :n].cpu(), c.ct.state[i, :n])
        add("counters.packets", g.counters.packets.cpu(), c.counters.packets)
        add("counters.bytes", g.counters.bytes.cpu(), c.counters.bytes)
        for name, x, y in zip(("flows.keys", "flows.counters"),
                              g.flows.state, c.flows.state):
            add(name, x.cpu(), y)
    return bad


def sharded_parity(plane, single, packed: np.ndarray) -> dict:
    """``packed`` through the sharded plane's ``classify_records`` and
    through the single engine's lane: verdict and identity on the rows
    whose 5-tuple stays on one shard, per-entry counters by global slot,
    and the union of the shards' live CT keys."""
    n = packed.shape[1]
    cross = cross_shard_rows(packed, plane.n_shards)
    t0 = time.perf_counter()
    v_s, i_s = plane.classify_records(soa_of(packed), n)
    sharded_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    v_o, i_o = single.serving().submit_records(soa_of(packed), n).result(
        timeout=SHARDED_WAIT_S)
    single_s = time.perf_counter() - t0
    keep = ~cross
    got_c = {}
    for k, sh in enumerate(plane.shards):
        got_c.update(entry_counters(sh._tables.datapath, sh.counters,
                                    plane.n_shards, k))
    want_c = entry_counters(single._tables.datapath, single.counters, 1, 0)
    keys_s = set().union(*(ct_live_keys(sh) for sh in plane.shards))
    keys_o = set(ct_live_keys(single))
    only_s, only_o = keys_s - keys_o, keys_o - keys_s
    lost_o = race_lost([single], only_s)
    lost_s = race_lost(plane.shards, only_o)
    return {"rows": n, "cross_shard_rows": int(cross.sum()),
            "mismatches": {
                "verdict": int((v_s[keep] != v_o[keep]).sum()),
                "identity": int((i_s[keep] != i_o[keep]).sum()),
                "counters": len(set(got_c.items()) ^ set(want_c.items())),
                "ct_keys_unexplained": len(only_s) - lost_o +
                len(only_o) - lost_s},
            "ct_keys_only_sharded": len(only_s),
            "ct_keys_only_single": len(only_o),
            "ct_keys_race_lost_single": lost_o,
            "ct_keys_race_lost_sharded": lost_s,
            "verdict_on_cross_rows_differ": int(
                (v_s[cross] != v_o[cross]).sum()),
            "ct_keys": len(keys_o), "counted_entries": len(want_c),
            "allowed_share": float((v_o >= 0).mean()),
            "sharded_s": sharded_s, "single_s": single_s}


def sharded_kill(plane, single, state4) -> dict:
    """A fatal launch fault on one shard's lane: the status names it, the
    siblings stay equal to the single engine with their breakers closed,
    the victim serves fail-static with its established flows kept, and
    gated recovery brings it back."""
    n = plane.n_shards
    victim = SHARDED_VICTIM
    lane = plane.serving()
    single_lane = single.serving()
    sup = lane.lanes[victim].supervisor
    pool = RecordPool(state4, seed=43)
    vips = {int(np.uint32(s.vip)) for s in state4.services}

    def both(c):
        rows = len(c["sport"])
        t = lane.submit_records({k: v.copy() for k, v in c.items()}, rows)
        v, i = t.result(timeout=SHARDED_WAIT_S)
        if t.error is not None:
            raise AssertionError(f"sharded-kill: {t.error!r}")
        vo, io_ = single_lane.submit_records(
            {k: v.copy() for k, v in c.items()}, rows).result(
            timeout=SHARDED_WAIT_S)
        return v, i, vo, io_

    c1 = pool.chunk(SHARDED_KILL)
    v1, i1, vo1, io1 = both(c1)
    before_bad = int((v1 != vo1).sum() + (i1 != io1).sum())
    sup.oracle.refresh()
    inj = DeviceFaultInjector()
    sup.install_fault_hook(inj)
    inj.fail_launch(times=1, fatal=True)
    kill = pool.chunk(4096)
    kill["endpoint"] = (kill["endpoint"] // n * n + victim).astype(np.int32)
    t0 = time.perf_counter()
    t = lane.submit_records(kill, 4096)
    t.result(timeout=SHARDED_WAIT_S)
    fail_static_s = time.perf_counter() - t0
    st = plane.supervision_status()
    degraded = {"mode": st["mode"], "degraded_shards": st["degraded-shards"],
                "ticket_error": repr(t.error) if t.error else None}

    siblings = {k: lane.lanes[k].batches for k in range(n) if k != victim}
    fresh = pool.chunk(SHARDED_KILL)
    v2, i2, vo2, io2 = both(fresh)
    mask = fresh["endpoint"] % n != victim
    sib_bad = {"verdict": int((v2[mask] != vo2[mask]).sum()),
               "identity": int((i2[mask] != io2[mask]).sum())}
    breakers = {k: lane.lanes[k].supervisor.breaker.state for k in siblings}
    launched = all(lane.lanes[k].batches > b for k, b in siblings.items())

    # established flows of the victim: its allowed rows of c1 that are
    # not service VIPs (fail-static answers policy, not NAT)
    t = lane.submit_records({k: v.copy() for k, v in c1.items()},
                            SHARDED_KILL)
    vs, _ = t.result(timeout=SHARDED_WAIT_S)
    daddr = c1["daddr"].view(np.uint32)
    est = (c1["endpoint"] % n == victim) & (v1 >= 0) & \
        ~np.isin(daddr, np.fromiter(vips, np.uint32, len(vips)))
    est_bad = int((vs[est] != v1[est]).sum())
    static_records = sup.fail_static_records

    inj.heal()
    t0 = time.perf_counter()
    while sup.mode != "ok" and time.perf_counter() - t0 < SHARDED_WAIT_S:
        lane.submit_records({k: v.copy() for k, v in kill.items()},
                            4096).result(timeout=SHARDED_WAIT_S)
        time.sleep(0.01)
    recovery_s = time.perf_counter() - t0
    return {"victim": victim, "degraded": degraded,
            "seconds_to_fail_static": fail_static_s,
            "sibling_rows": int(mask.sum()), "sibling_mismatches": sib_bad,
            "sibling_breakers": breakers, "siblings_launched": launched,
            "before_fault_mismatches": before_bad,
            "established_rows": int(est.sum()),
            "established_changed": est_bad,
            "fail_static_records": static_records,
            "seconds_to_recovery": recovery_s, "mode_after": sup.mode,
            "plane_mode_after": plane.supervision_status()["mode"]}


def sharded_dfa(dev) -> dict:
    """The config-3 HTTP DFA over 1,024-byte request lines, the payload
    axis split over four chunks on the card, against the serial scan."""
    eng = HTTPPolicyEngine(HTTP_RULES, device="cpu")
    compiled = eng._combined
    table = torch.as_tensor(compiled.table, device=dev)
    s = int(table.shape[0])
    chunk = DFA_LEN // SHARDS
    rows = min(DFA_ROWS, DFA_CHUNK_BYTES // (chunk * s * table.element_size()))
    reqs = config3_requests(rows)
    lines = []
    for r in reqs:
        head = http_request_line(r)
        pad = DFA_LEN - len(head.encode()) - 1
        lines.append(http_request_line(HTTPRequest(
            method=r.method, path=r.path + "/" + "x" * pad, host=r.host)))
    data = torch.as_tensor(dfa_ops.encode_strings(lines, DFA_LEN), device=dev)
    states = dfa_ops.start_states(torch.as_tensor(compiled.starts,
                                                  device=dev), rows)
    mesh = make_mesh(devices=[dev] * SHARDS)
    got = dfa_scan_sharded(table, states, data, mesh, DP_AXIS)
    want = dfa_ops.dfa_scan(table, states, data)
    accept = torch.as_tensor(compiled.accept, device=dev)
    ok = accept[got.long()]
    sharded_ms = cuda_ms(lambda: dfa_scan_sharded(table, states, data, mesh,
                                                  DP_AXIS), DFA_TIMED)
    serial_ms = cuda_ms(lambda: dfa_ops.dfa_scan(table, states, data),
                        DFA_TIMED)
    return {"rows": rows, "payload_bytes": DFA_LEN, "chunks": SHARDS,
            "states": s, "chunk_function_bytes":
            rows * chunk * s * table.element_size(),
            "mismatches": int((got != want).sum()),
            "matched_share": float(ok.any(dim=1).float().mean()),
            "sharded_ms": float(np.median(sharded_ms)),
            "serial_ms": float(np.median(serial_ms)), "samples": DFA_TIMED}


def sharded_agent(dev) -> dict:
    """``Daemon(DaemonConfig(dataplane_shards=4))`` on the card over its
    REST API: geometry, rows on the owning shard, ``/flows?shard=k``,
    and a shard fault named in the status until gated recovery."""
    state = policy_state(*POLICY_PROPAGATION)
    remotes = policy_remotes(state)
    packed, _ = policy_packets(state, remotes, SHARDED_AGENT_BATCH)
    d = Daemon(config=DaemonConfig(state_dir="", dataplane_shards=SHARDS,
                                   supervisor_reset_s=0.2,
                                   hubble_drain_interval_s=0),
               device=dev)
    srv = None
    try:
        srv = APIServer(d).start()
        url = srv.base_url
        for ep_id, ip, labels in state.endpoints:
            rest(url, "PUT", f"/endpoint/{ep_id}",
                 {"ipv4": ip, "labels": list(labels)})
        for ip, labels in state.peers:
            ident, _ = d.identity_allocator.allocate(
                Labels.from_model(list(labels)))
            d.ipcache.upsert(ip, ident.id, SOURCE_KVSTORE)
        rest(url, "PUT", "/policy", state.rules_json.encode())
        if not agent_settled(d, POLICY_WAIT_S):
            raise AssertionError("sharded-agent: builds did not finish")
        _, st = rest(url, "GET", "/healthz")
        geometry = st["dataplane"]["geometry"]
        # each endpoint's rows on its owning shard's slice, nowhere else
        misplaced = 0
        slots = []
        for ep_id, _ip, _l in state.endpoints:
            owner = d.table_mgr.shard_of_endpoint(ep_id)
            slot = d.table_mgr.slot_of(ep_id)
            slots.append(slot)
            misplaced += int(slot % SHARDS != owner)
            misplaced += sum(int((mgr.slot_of(ep_id) is not None) !=
                                 (k == owner))
                             for k, mgr in enumerate(d.table_mgr.shards))
        row_writes = [sh.pack_stats()["row-writes"]
                      for sh in d.datapath.shards]
        ep_row = PACKED_FIELDS.index("endpoint")
        packed[ep_row] = np.asarray(slots, np.int32)[packed[ep_row]]
        v, _i = d.datapath.classify_records(soa_of(packed),
                                            packed.shape[1])
        drained = d.hubble.drain()["drained"]
        per_shard = {}
        for k in range(SHARDS):
            _, ans = rest(url, "GET", f"/flows?shard={k}&n=200")
            per_shard[k] = {"flows": len(ans["flows"]),
                            "other_shard": sum(f["shard"] != k
                                               for f in ans["flows"]),
                            "partial": ans["partial"]}
        lane = d.datapath.serving()
        sup = lane.lanes[SHARDED_VICTIM].supervisor
        inj = DeviceFaultInjector()
        sup.install_fault_hook(inj)
        inj.fail_launch(times=1, fatal=True)
        victim_rows = packed[:, packed[ep_row] % SHARDS == SHARDED_VICTIM]
        lane.submit_records(soa_of(victim_rows),
                            victim_rows.shape[1]).result(
            timeout=SHARDED_WAIT_S)
        _, st = rest(url, "GET", "/healthz")
        degraded = {"mode": st["dataplane"]["mode"],
                    "degraded_shards": st["dataplane"]["degraded-shards"],
                    "names_shard": f"shard(s) [{SHARDED_VICTIM}]"
                    in st["dataplane"]["status"]}
        inj.heal()
        t0 = time.perf_counter()
        while sup.mode != "ok" and \
                time.perf_counter() - t0 < SHARDED_WAIT_S:
            lane.submit_records(soa_of(victim_rows),
                                victim_rows.shape[1]).result(
                timeout=SHARDED_WAIT_S)
            time.sleep(0.01)
        recovery_s = time.perf_counter() - t0
        _, st = rest(url, "GET", "/healthz")
        return {"endpoints": len(state.endpoints), "geometry": geometry,
                "misplaced_rows": misplaced, "row_writes": row_writes,
                "rows": int(packed.shape[1]),
                "allowed_share": float((v >= 0).mean()),
                "drained": drained, "flows_by_shard": per_shard,
                "degraded": degraded, "seconds_to_recovery": recovery_s,
                "status_after": st["dataplane"]["status"]}
    finally:
        if srv is not None:
            srv.shutdown()
        d.shutdown()


def sharded_timing(plane, single, state4) -> list:
    """``classify_records`` of the sharded plane against the single
    engine's lane, records/s at two sizes, and the card's busy share."""
    out = []
    for rows, iters in SHARDED_TIMED.items():
        soa = soa_of(next(v4_serving_packets(state4, rows, n_flows=V4_FLOWS,
                                             seed=59)))
        single_lane = single.serving()
        for name, fn in (
                ("sharded", lambda: plane.classify_records(soa, rows)),
                ("single", lambda: single_lane.submit_records(
                    soa, rows).result(timeout=SHARDED_WAIT_S))):
            fn()
            secs = []
            for _ in range(iters):
                t0 = time.perf_counter()
                fn()
                secs.append(time.perf_counter() - t0)
            _, busy, kernels, wall = device_busy_ms(fn)
            med = float(np.median(secs))
            out.append({"plane": name, "rows": rows,
                        "median_ms": med * 1e3,
                        "p99_ms": float(np.percentile(secs, 99)) * 1e3,
                        "samples": iters, "records_per_s": rows / med,
                        "busy_ms": busy, "kernels": kernels,
                        "busy_share": busy / (wall * 1e3)})
    return out


def phase_sharded(dev, state4) -> int:
    """The sharded dataplane on the card: four ep-shards on ``dev``
    against one engine, their CPU twin, a shard kill, the sharded DFA
    scan and a sharded agent; returns the dense kernel's launches (every
    shard runs the hash step)."""
    t_phase = time.perf_counter()
    planes = []
    for where in (dev, torch.device("cpu")):
        p = ShardedDatapath(n_shards=SHARDS, devices=[where] * SHARDS,
                            ct_slots=SHARDED_CT_SLOTS, ct_probe=V4_CT_PROBE)
        state4.load(p)
        enable_flows(p)
        p.enable_provenance()
        planes.append(p)
    plane, cpu_plane = planes
    cpu_plane.telemetry_enabled = False
    single = engine.Datapath(ct_slots=SHARDED_CT_SLOTS, ct_probe=V4_CT_PROBE,
                             device=dev)
    state4.load(single)
    enable_flows(single)
    single.enable_provenance()
    # the serving phase's knobs without its admission bound: a 2**20-row
    # submission is one record chunk here
    knobs = {k: v for k, v in SERVING_KNOBS.items() if k != "max_pending"}
    for p in (plane, single):
        p.configure_supervision(**knobs)
    setup_s = time.perf_counter() - t_phase
    dv.dense_verdict.launches = 0
    try:
        # ---- sharded-twin: the card against the CPU, one clock ----
        twin_rows = next(v4_serving_packets(state4, SHARDED_TWIN,
                                            n_flows=V4_FLOWS, seed=53))
        twin = sharded_twin(plane, cpu_plane, twin_rows, V4_T0)
        emit("sharded-twin", rows=SHARDED_TWIN, shards=SHARDS,
             mismatches=twin, ct_entries=plane.ct_entries(),
             setup_s=setup_s, name_power_limit=nvidia_smi("name,power.limit"))
        del cpu_plane, planes
        # start the parity leg from empty CT tables and zeroed counters
        plane.gc(now=(1 << 31) - 1)
        for sh in plane.shards:
            sh.counters.packets.zero_()
            sh.counters.bytes.zero_()

        # ---- sharded-parity: 2**20 rows, sharded against one engine ----
        packed = balanced_batch(state4, SHARDED_BATCH // SHARDS, SHARDS,
                                seed=57)
        parity = sharded_parity(plane, single, packed)
        emit("sharded-parity", shards=SHARDS, ct_slots=SHARDED_CT_SLOTS,
             geometry=plane.geometry(), **parity,
             name_power_limit=nvidia_smi("name,power.limit"))

        # ---- sharded-kill ----
        kill = sharded_kill(plane, single, state4)
        emit("sharded-kill", **kill,
             name_power_limit=nvidia_smi("name,power.limit"))

        # ---- sharded-timing ----
        timing = sharded_timing(plane, single, state4)
        for row in timing:
            emit("sharded-timing", **row,
                 name_power_limit=nvidia_smi("name,power.limit"))
    finally:
        plane.serving().close()
        single.serving().close()

    # ---- sharded-dfa ----
    dfa = sharded_dfa(dev)
    emit("sharded-dfa", **dfa, name_power_limit=nvidia_smi("name,power.limit"))

    # ---- sharded-agent ----
    agent = sharded_agent(dev)
    emit("sharded-agent", **agent,
         name_power_limit=nvidia_smi("name,power.limit"))
    launches = dv.dense_verdict.launches

    counts = list(twin.values()) + list(parity["mismatches"].values()) + [
        kill["degraded"]["degraded_shards"] != [SHARDED_VICTIM],
        kill["degraded"]["ticket_error"] is not None,
        sum(kill["sibling_mismatches"].values()),
        set(kill["sibling_breakers"].values()) != {"closed"},
        not kill["siblings_launched"], kill["before_fault_mismatches"],
        kill["established_changed"], kill["established_rows"] == 0,
        kill["fail_static_records"] == 0, kill["mode_after"] != "ok",
        kill["plane_mode_after"] != "ok", dfa["mismatches"],
        dfa["chunk_function_bytes"] >= DFA_CHUNK_BYTES,
        agent["geometry"]["ep"] != SHARDS, agent["misplaced_rows"],
        any(s["flows"] == 0 or s["other_shard"]
            for s in agent["flows_by_shard"].values()),
        agent["degraded"]["degraded_shards"] != [SHARDED_VICTIM],
        not agent["degraded"]["names_shard"],
        agent["status_after"] != "ok"]
    if any(counts):
        raise AssertionError(f"sharded: {counts}")
    emit("sharded", seconds=time.perf_counter() - t_phase,
         hand_kernel_launches={"dense_verdict": launches},
         cross_shard_rows=parity["cross_shard_rows"],
         name_power_limit=nvidia_smi("name,power.limit"))
    return launches


# ---------------------------------------------------------------------------
# The L7 proxy data plane: the card's redirect meets the socket proxy
# ---------------------------------------------------------------------------

PROXY_ROWS = 4096
PROXY_CT_SLOTS = 1 << 16
PROXY_BATCHED = 256             # concurrent connections of the batched leg
PROXY_BATCH_WINDOW = 0.002
PROXY_NAT_ROWS = 1 << 20
PROXY_WAIT_S = 60.0
PROXY_IO_S = 10.0               # deadline of one socket read
REENTRY_ID, REENTRY_PORT = 777, 9000
OK_REPLY = b"HTTP/1.1 200 OK\r\ncontent-length: 2\r\n\r\nok"


class ProxyUpstream(socketserver.ThreadingTCPServer):
    """A loopback upstream: one 200 per request head (HTTP), or one
    ``END`` per line (memcached); remembers its peers (the proxy's
    upstream legs) and how many requests it answered."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, kind: str, host: str = "127.0.0.1", port: int = 0):
        self.kind = kind
        self.peers = []
        self.answered = 0
        self.lock = threading.Lock()
        super().__init__((host, port), _ProxyUpHandler)
        self._thread = threading.Thread(target=self.serve_forever,
                                        args=(0.05,), daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self.server_address[1]

    def close(self) -> None:
        self.shutdown()
        self.server_close()


class _ProxyUpHandler(socketserver.BaseRequestHandler):
    def handle(self):
        srv = self.server
        with srv.lock:
            srv.peers.append(self.client_address)
        sep, reply = (b"\r\n\r\n", OK_REPLY) if srv.kind == "http" else \
            (b"\r\n", b"END\r\n")
        buf = b""
        while True:
            try:
                data = self.request.recv(65536)
            except OSError:
                return
            if not data:
                return
            buf += data
            while sep in buf:
                _req, buf = buf.split(sep, 1)
                with srv.lock:
                    srv.answered += 1
                self.request.sendall(reply)


def http_call(port: int, head: bytes, host: str = "127.0.0.1") -> bytes:
    """The response to one request on a fresh connection, read to the
    upstream's ``ok``, the proxy's deny or EOF."""
    try:
        s = socket.create_connection((host, port), timeout=PROXY_IO_S)
    except OSError:
        return b""
    buf = b""
    try:
        s.settimeout(PROXY_IO_S)
        s.sendall(head)
        while not buf.endswith(b"ok") and b"denied" not in buf:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    except OSError:
        pass
    finally:
        s.close()
    return buf


def http_head(req: HTTPRequest) -> bytes:
    return (f"{req.method} {req.path} HTTP/1.1\r\nHost: {req.host}\r\n"
            f"content-length: 0\r\n\r\n").encode()


def verdict_of(resp: bytes):
    """True (forwarded), False (denied in-protocol) or None (neither)."""
    if resp.startswith(b"HTTP/1.1 200"):
        return True
    if resp.startswith(b"HTTP/1.1 403"):
        return False
    return None


def request_of(match_string: str) -> HTTPRequest:
    method, path, host = match_string.split("\x00")
    return HTTPRequest(method=method, path=path, host=host)


def http_listener(redirect_id: str, upstream, engine) -> ListenerContext:
    return ListenerContext(
        redirect_id=redirect_id, parser_type="http",
        orig_dst=lambda peer: ("127.0.0.1", upstream.port),
        http_engine_for=lambda peer: engine)


def proxy_l7(dev, state4) -> dict:
    """``l7_frame`` rows through the v4 step on the card with the L7
    fast stage on; every HTTP row's request then goes over TCP through a
    ``SocketProxy`` listening at the port the card redirected to."""
    t0 = time.perf_counter()
    l7st = l7_serving_state(state4)
    dp = engine.Datapath(ct_slots=PROXY_CT_SLOTS, ct_probe=V4_CT_PROBE,
                         device=dev)
    l7st.v4.load(dp)
    set_stages(dp, "l7fast", l7st)
    width = dp.l7_fast_window()
    picked = []
    soa, strings = l7_frame(RecordPool(state4, seed=61), l7st,
                            np.random.default_rng(62), PROXY_ROWS,
                            picked=picked)
    packed = torch.as_tensor(np.stack([soa[f] for f in PACKED_FIELDS]))
    payload = torch.as_tensor(encode_payloads(strings, width))
    v, _e, _i, _nat = dp.process_packed(packed.to(dev), now=V4_T0,
                                        payload=payload.to(dev))
    v = v.cpu().numpy()
    setup_s = time.perf_counter() - t0
    http = (soa["dport"] == 80) & (soa["direction"] == 0) & \
        (soa["proto"] == 6)
    redirected = http & (v > 0)
    ports = sorted({int(p) for p in v[redirected]})
    if ports != [L7_HTTP_PORT]:
        raise AssertionError(f"proxy-l7: redirect ports {ports}")
    # rows the card decided before the L7 tier (a service VIP's DNAT to
    # another port, then the policy) are not proxy traffic
    l7_tier = http & ((v > 0) | (v == 0) | (v == VERDICT_DROP_L7))
    rows = np.flatnonzero(l7_tier)
    reqs = [request_of(strings[j] if strings[j] is not None else picked[j])
            for j in rows]
    eng = HTTPPolicyEngine(list(HTTP_RULES), device=dev)
    patterns = [rule_to_combined_regex(r) for r in HTTP_RULES]
    upstream = ProxyUpstream("http")
    proxy = SocketProxy(access_log=AccessLog())
    rid = proxy_id(0, True, "TCP", 80)
    try:
        bound = proxy.start_listener(ports[0], http_listener(rid, upstream,
                                                             eng))
        t1 = time.perf_counter()
        got = [verdict_of(http_call(bound, http_head(r))) for r in reqs]
        send_s = time.perf_counter() - t1
        stats = proxy.proxy_stats()
    finally:
        proxy.shutdown()
        upstream.close()
    want_eng = eng.check(reqs)
    want_re = [any(oracle_match(p, http_request_line(r).encode())
                   for p in patterns) for r in reqs]
    mism = {"unanswered": 0, "engine": 0, "oracle": 0, "card_inline": 0}
    counts = {"proxy_allow": 0, "proxy_deny": 0, "redirected_allow": 0,
              "redirected_deny": 0, "inline_allow": 0, "inline_deny": 0}
    for k, j in enumerate(rows):
        g = got[k]
        mism["unanswered"] += g is None
        mism["engine"] += g != bool(want_eng[k])
        mism["oracle"] += g != want_re[k]
        counts["proxy_allow" if g else "proxy_deny"] += 1
        if v[j] > 0:
            counts["redirected_allow" if g else "redirected_deny"] += 1
        else:
            counts["inline_allow" if v[j] == 0 else "inline_deny"] += 1
            mism["card_inline"] += g != (v[j] == 0)
    return {"rows": PROXY_ROWS, "http_rows": int(http.sum()),
            "l4_dropped": int((http & ~l7_tier).sum()),
            "redirected": int(redirected.sum()), "port": ports[0],
            **{k: int(x) for k, x in counts.items()},
            "mismatches": {k: int(x) for k, x in mism.items()},
            "proxied_connections": stats.get(rid, 0),
            "upstream_answered": upstream.answered,
            "setup_s": setup_s, "send_s": send_s,
            "ms_per_connection": send_s * 1e3 / max(1, len(reqs))}


def proxy_batched(dev) -> dict:
    """``PROXY_BATCHED`` concurrent connections through a
    ``SocketProxy(http_batch_window=...)`` whose HTTP engine lives on
    the card: every verdict equal to the scalar tier, no failed batch,
    and the DFA walk seen on the card by ``torch.profiler``."""
    eng = HTTPPolicyEngine(list(HTTP_RULES), device=dev)
    reqs = config3_requests(PROXY_BATCHED)
    scalar = [eng.check_one(r) for r in reqs]
    upstream = ProxyUpstream("http")
    proxy = SocketProxy(access_log=AccessLog(),
                        http_batch_window=PROXY_BATCH_WINDOW)
    got = [None] * PROXY_BATCHED
    try:
        bound = proxy.start_listener(0, http_listener("batched", upstream,
                                                      eng))
        # one warm-up request compiles nothing but settles the lane
        http_call(bound, http_head(reqs[0]))

        def run():
            def one(k):
                got[k] = verdict_of(http_call(bound, http_head(reqs[k])))
            threads = [threading.Thread(target=one, args=(k,))
                       for k in range(PROXY_BATCHED)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=PROXY_WAIT_S)

        _, busy_ms, kernels, wall = device_busy_ms(run)
        stats = proxy._http_batchers[id(eng)][1].stats()
    finally:
        proxy.shutdown()
        upstream.close()
    return {"connections": PROXY_BATCHED, "window_s": PROXY_BATCH_WINDOW,
            **stats, "allowed": sum(bool(g) for g in got),
            "mismatches": sum(g != s for g, s in zip(got, scalar)),
            "card_kernels": kernels, "card_busy_ms": busy_ms,
            "seconds": wall}


def proxy_reentry(dev) -> dict:
    """The marked upstream leg of a proxied memcached connection as
    ``mark_identity`` of a v4 batch on the card and on the CPU."""
    outs = {}
    upstream = ProxyUpstream("memcache")
    proxy = SocketProxy()
    c = None
    try:
        ctx = ListenerContext(
            redirect_id="reentry", parser_type="memcache",
            orig_dst=lambda peer: ("127.0.0.1", upstream.port),
            l7_rules=lambda peer: [PortRuleL7.from_dict(
                {"command": "get", "key": "*"})],
            identities=lambda peer: (REENTRY_ID, 888))
        c = socket.create_connection(
            ("127.0.0.1", proxy.start_listener(0, ctx)), timeout=PROXY_IO_S)
        c.sendall(b"get a\r\n")
        buf = b""
        while b"END" not in buf:
            chunk = c.recv(65536)
            if not chunk:
                break
            buf += chunk
        leg = upstream.peers[-1]
        mark = proxy.mark_for(leg)
        st = PolicyMapState()
        st[PolicyKey(identity=REENTRY_ID, dest_port=REENTRY_PORT,
                     nexthdr=6, direction=0)] = PolicyMapStateEntry()
        for key, where in (("card", dev), ("cpu", torch.device("cpu"))):
            dp = engine.Datapath(ct_slots=1 << 8, ct_probe=4, device=where)
            dp.load_policy([st], revision=1, ipcache_prefixes={})
            v, _e, ident, _n = dp.process(engine.make_full_batch(
                endpoint=[0, 0], saddr=[leg[0]] * 2,
                daddr=["10.5.0.2"] * 2, sport=[leg[1], leg[1] + 1],
                dport=[REENTRY_PORT] * 2, direction=[0, 0],
                mark_identity=[mark, 0], device=where), now=V4_T0)
            outs[key] = (v.cpu().tolist(), ident.cpu().tolist())
    finally:
        if c is not None:
            c.close()
        proxy.shutdown()
        upstream.close()
    deadline = time.monotonic() + PROXY_IO_S
    while proxy.mark_for(leg) and time.monotonic() < deadline:
        time.sleep(0.01)
    (v, ident) = outs["card"]
    return {"mark": mark, "identity": ident[0], "verdict": v[0],
            "unmarked_identity": ident[1], "unmarked_verdict": v[1],
            "card_equals_cpu": outs["card"] == outs["cpu"],
            "mark_after_close": proxy.mark_for(leg)}


def free_port(host: str) -> int:
    probe = socket.socket()
    probe.bind((host, 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def xds_rule(name: str, port: int, path: str) -> dict:
    return {"endpointSelector": {"matchLabels": {"k8s:app": "proxied"}},
            "labels": [f"k8s:rule={name}"],
            "ingress": [{"toPorts": [{
                "ports": [{"port": str(port), "protocol": "TCP"}],
                "rules": {"http": [{"method": "GET", "path": path}]}}]}]}


def proxy_xds(dev) -> dict:
    """The agent on the card serving xDS to the supervised child on the
    card: a redirect made through ``PUT /policy`` enforced on live TCP,
    the child killed with SIGKILL and back, then a second import."""
    ep_ip = "127.0.0.2"
    to_port = free_port(ep_ip)
    upstream = ProxyUpstream("http", host=ep_ip, port=to_port)
    AGENT_STATE_ROOT.mkdir(parents=True, exist_ok=True)
    state_dir = tempfile.mkdtemp(prefix="proxy-agent-",
                                 dir=AGENT_STATE_ROOT)
    d = Daemon(config=DaemonConfig(state_dir=state_dir,
                                   ct_slots=PROXY_CT_SLOTS), device=dev)
    srv = sup = None
    res = {}
    try:
        srv = APIServer(d).start()
        xds_port = d.serve_xds().port
        rest(srv.base_url, "PUT", "/endpoint/7",
             {"ipv4": ep_ip, "labels": ["k8s:app=proxied"]})
        _, imp = rest(srv.base_url, "PUT", "/policy", json.dumps(
            [xds_rule("xds-v1", to_port, "/v1/.*")]).encode())
        if not d.wait_for_policy_revision(imp["revision"],
                                          timeout=PROXY_WAIT_S):
            raise AssertionError("proxy-xds: the import did not settle")
        redir = d.proxy.get(proxy_id(7, True, "TCP", to_port))
        v1 = d.xds_cache._version_of(TYPE_NETWORK_POLICY)
        t0 = time.perf_counter()
        sup = ProxySupervisor(xds_port, backoff_base=0.05,
                              device=str(dev)).start()
        res["child_ready_s"] = time.perf_counter() - t0
        if not d.xds_cache.wait_for_acks(TYPE_NETWORK_POLICY,
                                         v1).wait(PROXY_WAIT_S):
            raise AssertionError("proxy-xds: the child never ACKed")
        res["first_ack_s"] = time.perf_counter() - t0
        get = lambda path: verdict_of(http_call(  # noqa: E731
            redir.proxy_port, http_head(HTTPRequest("GET", path, "h"))))
        res["v1"] = {"/v1/a": get("/v1/a"), "/v2/a": get("/v2/a"),
                     "/admin": get("/admin")}
        pid = sup.pid
        t0 = time.perf_counter()
        os.kill(pid, signal.SIGKILL)
        while time.perf_counter() - t0 < PROXY_WAIT_S and not (
                sup.pid not in (None, pid) and get("/v1/b") is True):
            time.sleep(0.05)
        res["enforce_after_kill_s"] = time.perf_counter() - t0
        res["restarts"] = sup.restarts
        t0 = time.perf_counter()
        _, imp = rest(srv.base_url, "PUT", "/policy", json.dumps(
            [xds_rule("xds-v2", to_port, "/v2/.*")]).encode())
        if not d.wait_for_policy_revision(imp["revision"],
                                          timeout=PROXY_WAIT_S):
            raise AssertionError("proxy-xds: the second import stalled")
        v2 = d.xds_cache._version_of(TYPE_NETWORK_POLICY)
        res["v2_acked"] = d.xds_cache.wait_for_acks(
            TYPE_NETWORK_POLICY, v2).wait(PROXY_WAIT_S)
        res["v2_ack_s"] = time.perf_counter() - t0
        res["v2"] = {"/v1/a": get("/v1/a"), "/v2/a": get("/v2/a"),
                     "/admin": get("/admin")}
        res["proxy_port"] = redir.proxy_port
        res["nacks"] = len(d.xds_cache.nacks)
        res["upstream_answered"] = upstream.answered
        res["child_pid"] = sup.pid
    finally:
        if sup is not None:
            sup.shutdown()
        if srv is not None:
            srv.shutdown()
        d.shutdown()
        upstream.close()
        shutil.rmtree(state_dir, ignore_errors=True)
    pids = [p for p in (res.get("child_pid"),) if p]
    res["child_left"] = any(os.path.exists(f"/proc/{p}") for p in pids)
    return res


def nat_csum(dev) -> dict:
    """csum and NAT46 on ``PROXY_NAT_ROWS`` seeded rows, card against
    CPU; the incremental fix against the recomputed checksum."""
    rng = np.random.default_rng(71)
    n = PROXY_NAT_ROWS
    u16 = lambda: rng.integers(0, 1 << 16, n).astype(np.int32)  # noqa
    u32 = lambda: rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(  # noqa
        np.uint32).view(np.int32)
    words = rng.integers(0, 1 << 16, (n, 10)).astype(np.int32)
    words[rng.random(n) < 0.05] = 0
    old_a = ((words[:, 0].astype(np.uint32) << 16) |
             words[:, 1].astype(np.uint32)).view(np.int32)
    new_a, new_p, c16 = u32(), u16(), u16()
    c16[rng.random(n) < 0.1] = 0
    c16[rng.random(n) < 0.1] = 0xFFFF
    new_words = words.copy()
    new_words[:, 0] = (new_a.view(np.uint32) >> 16).astype(np.int32)
    new_words[:, 1] = (new_a.view(np.uint32) & 0xFFFF).astype(np.int32)
    new_words[:, 2] = new_p
    prefix = (0x0064FF9B, 0, 0, 0)
    outs = {}
    t0 = time.perf_counter()
    for key, where in (("card", dev), ("cpu", torch.device("cpu"))):
        t = lambda a: torch.as_tensor(a).to(where)  # noqa: E731
        base = csum.checksum16(t(words))
        v6 = nat46.nat46_translate(t(new_a), prefix)
        back, ok = nat46.nat64_translate(v6, prefix)
        outs[key] = {
            "checksum16": base,
            "fix_tcp": csum.nat_csum_fix(base, t(old_a), t(new_a),
                                         t(words[:, 2]), t(new_p)),
            "fix_udp": csum.nat_csum_fix(t(c16), t(old_a), t(new_a),
                                         t(words[:, 2]), t(new_p),
                                         udp=True),
            "u32": csum.csum_update_u32(t(c16), t(old_a), t(new_a)),
            "recomputed": csum.checksum16(t(new_words)),
            "nat46": v6, "nat64": back, "nat64_ok": ok,
            "roundtrip": nat46.nat46_roundtrip_ok(t(new_a), prefix)}
        outs[key] = {k: x.cpu() for k, x in outs[key].items()}
    card, cpu = outs["card"], outs["cpu"]
    mism = {k: int((card[k] != cpu[k]).sum()) for k in card}
    mism["fix_vs_recomputed"] = int((card["fix_tcp"] !=
                                     card["recomputed"]).sum())
    mism["roundtrip_failed"] = int((~card["roundtrip"]).sum())
    mism["udp_zero_kept"] = int((card["fix_udp"][torch.as_tensor(c16 == 0)]
                                 != 0).sum())
    return {"rows": n, "mismatches": mism,
            "seconds": time.perf_counter() - t0}


def phase_proxy(dev, state4) -> int:
    """The L7 proxy data plane on the card; returns the dense kernel's
    launches on its path (none)."""
    t_phase = time.perf_counter()
    dv.dense_verdict.launches = 0
    l7 = proxy_l7(dev, state4)
    emit("proxy-l7", **l7, name_power_limit=nvidia_smi("name,power.limit"))
    batched = proxy_batched(dev)
    emit("proxy-batched", **batched,
         name_power_limit=nvidia_smi("name,power.limit"))
    reentry = proxy_reentry(dev)
    emit("proxy-reentry", **reentry)
    xds_leg = proxy_xds(dev)
    emit("proxy-xds", **xds_leg,
         name_power_limit=nvidia_smi("name,power.limit"))
    nat = nat_csum(dev)
    emit("nat-csum", **nat)
    launches = dv.dense_verdict.launches
    want_v1 = {"/v1/a": True, "/v2/a": False, "/admin": False}
    want_v2 = {"/v1/a": True, "/v2/a": True, "/admin": False}
    counts = [sum(l7["mismatches"].values()), not l7["redirected"], not l7["inline_allow"],
              not l7["inline_deny"], not l7["redirected_allow"],
              not l7["redirected_deny"],
              l7["proxied_connections"] !=
              l7["http_rows"] - l7["l4_dropped"],
              batched["mismatches"], batched["errors"],
              batched["checked"] < PROXY_BATCHED,
              batched["card_kernels"] == 0,
              reentry["mark"] != REENTRY_ID,
              reentry["identity"] != REENTRY_ID, reentry["verdict"] != 0,
              reentry["unmarked_identity"] != WORLD_IDENTITY,
              reentry["unmarked_verdict"] >= 0,
              not reentry["card_equals_cpu"], reentry["mark_after_close"],
              xds_leg["v1"] != want_v1, xds_leg["v2"] != want_v2,
              not xds_leg["v2_acked"], xds_leg["restarts"] < 1,
              xds_leg["child_left"], sum(nat["mismatches"].values())]
    if any(counts):
        raise AssertionError(f"proxy: {counts}")
    emit("proxy", seconds=time.perf_counter() - t_phase,
         hand_kernel_launches={"dense_verdict": launches},
         name_power_limit=nvidia_smi("name,power.limit"))
    return launches


# ---------------------------------------------------------------------------
# hostint: the host integrations over the agent on the card
# ---------------------------------------------------------------------------

HOSTINT_STATE = POLICY_STATE            # policy_state(): the rules-to-verdicts
HOSTINT_PROPAGATION = POLICY_PROPAGATION  # state, and policy-propagation's
HOSTINT_NS = "prod"
HOSTINT_NODES = 256
HOSTINT_SERVICES = 1000
HOSTINT_BACKENDS = 4
HOSTINT_TOSERVICES = 8                  # CNPs whose egress names a service
HOSTINT_BATCH = 1 << 20
HOSTINT_VIP_ROWS = 4096                 # rows of the batch sent to service VIPs
HOSTINT_RELIST_ROWS = 1 << 16
HOSTINT_CHANGES = 10                    # CNP upserts, and as many deletes
HOSTINT_PROBED = 32                     # nodes whose v6 address an engine serves
HOSTINT_PACK_CT = 1 << 20
HOSTINT_WAIT_S = 300.0
HOSTINT_CT_SLOTS = POLICY_CT_SLOTS
HOSTINT_NOW_AHEAD_S = 900
HOSTINT_LOCAL = ("192.168.100.1", "fd00:10::1")   # this node's addresses
HOSTINT_NEW_IP = "10.131.0.2"                     # the CNI leg's pod
# a pod's container as kubelet labels it (the runtime watchers' sinks
# prefix these k8s:)
HOSTINT_CONTAINER_LABELS = {"app": "web",
                            "io.kubernetes.pod.namespace": "prod"}


def hostint_cid(name: str) -> str:
    """A 64-hex container id, as a runtime hands CNI one."""
    import hashlib
    return hashlib.sha256(name.encode()).hexdigest()


def np_of_rule(rule: dict, name: str):
    """``rule`` as a Kubernetes NetworkPolicy, or None where a
    NetworkPolicy cannot say it (an L7 rule, ``fromRequires``)."""
    def sel(s):
        return {"matchLabels": {k.split(":", 1)[-1]: v
                                for k, v in s["matchLabels"].items()}}
    spec = {"podSelector": sel(rule["endpointSelector"])}
    for key, peer_sel, peer_cidr, side in (
            ("ingress", "fromEndpoints", "fromCIDR", "from"),
            ("egress", "toEndpoints", "toCIDR", "to")):
        for r in rule.get(key, []):
            if set(r) - {peer_sel, peer_cidr, "toPorts"}:
                return None
            peers = [{"podSelector": sel(s)} for s in r.get(peer_sel, [])] + \
                [{"ipBlock": {"cidr": c}} for c in r.get(peer_cidr, [])]
            ports = []
            for pr in r.get("toPorts", []):
                if pr.get("rules"):
                    return None
                ports += [{"port": int(p["port"]), "protocol": p["protocol"]}
                          for p in pr["ports"]]
            item = {}
            if peers:
                item[side] = peers
            if ports:
                item["ports"] = ports
            spec.setdefault(key, []).append(item)
    return {"apiVersion": "networking.k8s.io/v1", "kind": "NetworkPolicy",
            "metadata": {"name": name, "namespace": HOSTINT_NS},
            "spec": spec}


def hostint_objects(state, seed: int = 31) -> dict:
    """``state`` as Kubernetes objects: its rules as CNPs, every other
    one NetworkPolicy can say as a NetworkPolicy; its endpoints and
    peers as pods (the endpoints on this node); ``HOSTINT_NODES`` nodes
    with pod CIDRs and a v4 and a v6 InternalIP; ``HOSTINT_SERVICES``
    ClusterIP services of ``HOSTINT_BACKENDS`` pod backends each with
    their Endpoints; ``HOSTINT_TOSERVICES`` CNPs whose egress names a
    service."""
    rng = np.random.default_rng(seed)
    ns = HOSTINT_NS
    cnps, nps = [], []
    for i, rule in enumerate(json.loads(state.rules_json)):
        as_np = np_of_rule(rule, f"np-{i}") if i % 2 else None
        if as_np is not None:
            nps.append(as_np)
        else:
            cnps.append({"apiVersion": "cilium.io/v2",
                         "kind": "CiliumNetworkPolicy",
                         "metadata": {"name": f"cnp-{i}", "namespace": ns},
                         "spec": rule})
    nodes = [{"metadata": {"name": f"node-{k}"},
              "spec": {"podCIDR": f"10.144.{k}.0/24"},
              "status": {"addresses": [
                  {"type": "InternalIP",
                   "address": f"192.168.{k // 250}.{k % 250 + 2}"},
                  {"type": "InternalIP", "address": f"fd00:10::{k + 2:x}"}]}}
             for k in range(HOSTINT_NODES)]
    work = [(ip, labels) for _id, ip, labels in state.endpoints] + \
        list(state.peers)
    pods = []
    for w, (ip, labels) in enumerate(work):
        host = HOSTINT_LOCAL[0] if w < len(state.endpoints) else \
            nodes[w % HOSTINT_NODES]["status"]["addresses"][0]["address"]
        pods.append({"metadata": {"name": f"pod-{w}", "namespace": ns,
                                  "labels": dict(l.split(":", 1)[1]
                                                 .split("=", 1)
                                                 for l in labels)},
                     "spec": {}, "status": {"podIP": ip, "hostIP": host}})
    pod_ips = [ip for ip, _l in work]
    services, endpoints = [], []
    for s in range(HOSTINT_SERVICES):
        port, target = (80, 8080) if s % 2 == 0 else (443, 8443)
        services.append({"metadata": {"name": f"svc-{s}", "namespace": ns},
                         "spec": {"clusterIP":
                                  f"10.96.{s // 250}.{s % 250 + 1}",
                                  "ports": [{"port": port,
                                             "targetPort": target,
                                             "protocol": "TCP"}]}})
        backends = rng.choice(len(pod_ips), HOSTINT_BACKENDS, replace=False)
        endpoints.append({"metadata": {"name": f"svc-{s}", "namespace": ns},
                          "subsets": [{"addresses": [
                              {"ip": pod_ips[b]} for b in backends],
                              "ports": [{"port": target}]}]})
    for k in range(HOSTINT_TOSERVICES):
        cnps.append({"apiVersion": "cilium.io/v2",
                     "kind": "CiliumNetworkPolicy",
                     "metadata": {"name": f"tosvc-{k}", "namespace": ns},
                     "spec": {"endpointSelector": {"matchLabels": {
                         "k8s:app": POLICY_APPS[k % len(POLICY_APPS)]}},
                         "egress": [{"toServices": [{"k8sService": {
                             "serviceName": f"svc-{k}", "namespace": ns}}]}],
                         "labels": [f"k8s:rule=s{k}"]}})
    return {"cnps": cnps, "nps": nps, "pods": pods, "nodes": nodes,
            "services": services, "endpoints": endpoints,
            "namespaces": [{"metadata": {"name": ns,
                                         "labels": {"env": "production"}}}]}


def hostint_cni_config(labels) -> dict:
    """The CNI ADD config of a pod with ``labels`` (``k8s:key=value``)."""
    out = dict(l.split(":", 1)[1].split("=", 1) for l in labels)
    out["io.kubernetes.pod.namespace"] = HOSTINT_NS
    return out


def hostint_feed_twin(b, url, objs, state) -> None:
    """What the watcher gives the agent, given to the twin directly: the
    pods' addresses as the watcher enters them, the nodes, the node's
    pods through CNI ADD over the twin's REST API, then the rules parsed
    by the port's ``parse_cnp`` / ``parse_network_policy`` with the
    services' backends translated in, in one import, and the services by
    ``service_upsert`` in the apiserver's order.  An operator's order,
    not kubelet's: the import after the pods builds every endpoint with
    every identity, the state agent A reaches only after its
    ``trigger_policy_updates`` round (``k8s_sync``), so the parity check
    also holds A's end state against a second order."""
    for pod in objs["pods"]:
        meta, st = pod["metadata"], pod["status"]
        b.ipcache.upsert(st["podIP"], RESERVED_UNMANAGED, "k8s",
                         host_ip=st["hostIP"],
                         metadata=f"pod:{meta['namespace']}/{meta['name']}")
    for node in objs["nodes"]:
        b.node_manager.node_updated(Node(
            name=node["metadata"]["name"], cluster=b.config.cluster_name,
            addresses=[NodeAddress(a["type"], a["address"])
                       for a in node["status"]["addresses"]],
            ipv4_alloc_cidr=node["spec"]["podCIDR"]))
    hostint_cni_pods(url, state)
    backends = {e["metadata"]["name"]: k8s_translate.endpoints_to_ips(e)
                for e in objs["endpoints"]}
    rules = [r for o in objs["cnps"] for r in k8s_parse_cnp(o)] + \
        [r for o in objs["nps"] for r in k8s_parse_network_policy(o)]
    for name, ips in backends.items():
        k8s_translate.translate_to_services(rules, name, HOSTINT_NS, ips)
    b.policy_add(rules)
    for svc in objs["services"]:
        p = svc["spec"]["ports"][0]
        b.service_upsert(svc["spec"]["clusterIP"], p["port"],
                         [(ip, p["targetPort"])
                          for ip in backends[svc["metadata"]["name"]]])


def vip_rows(packed, objs, slot_of, seed: int = 33) -> dict:
    """The last ``HOSTINT_VIP_ROWS`` rows of ``packed`` made egress TCP
    SYNs from the local endpoints to service VIPs; {row: the service's
    backend addresses (int32 bits)}."""
    rng = np.random.default_rng(seed)
    col = {f: i for i, f in enumerate(PACKED_FIELDS)}
    backends = {e["metadata"]["name"]: k8s_translate.endpoints_to_ips(e)
                for e in objs["endpoints"]}
    rows = np.arange(packed.shape[1] - HOSTINT_VIP_ROWS, packed.shape[1])
    picks = rng.integers(0, len(objs["services"]), len(rows))
    u32 = lambda ip: np.uint32(int(ipaddress.IPv4Address(ip))).view(  # noqa
        np.int32)
    want = {}
    for r, s in zip(rows.tolist(), picks.tolist()):
        svc = objs["services"][s]
        slot = int(rng.integers(0, len(slot_of)))
        packed[col["endpoint"], r] = slot_of[slot][0]
        packed[col["saddr"], r] = u32(slot_of[slot][1])
        packed[col["daddr"], r] = u32(svc["spec"]["clusterIP"])
        packed[col["dport"], r] = svc["spec"]["ports"][0]["port"]
        packed[col["proto"], r] = 6
        packed[col["direction"], r] = 1
        packed[col["tcp_flags"], r] = conntrack.TCP_SYN
        want[r] = {int(u32(ip)) for ip in backends[svc["metadata"]["name"]]}
    return want


def retarget(packed, slot_map) -> np.ndarray:
    """``packed`` with endpoint i's rows on table slot ``slot_map[i]``."""
    out = packed.copy()
    row = PACKED_FIELDS.index("endpoint")
    out[row] = np.asarray(slot_map, np.int32)[packed[row]]
    return out


def hostint_settled(d, timeout: float = HOSTINT_WAIT_S) -> bool:
    """``agent_settled`` and ``Daemon.wait_for_regenerations`` (an
    identity change regenerates without a new revision)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if agent_settled(d, max(1.0, deadline - time.monotonic())) and \
                d.wait_for_regenerations(
                    max(1.0, deadline - time.monotonic())) and \
                agent_settled(d, 1.0):
            return True
    return False


class MiniDockerd:
    """A dockerd on a unix socket for the runtime watcher: the container
    list, inspect, and a ``/events`` stream of start and die events."""

    def __init__(self, path: str):
        import http.server

        outer = self
        self.path = path
        self.cond = threading.Condition()
        self.containers, self.events = {}, []

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *_a):
                pass

            def address_string(self):
                return "unix"

            def _json(self, code, obj):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802 — http.server's name
                if self.path.startswith("/events"):
                    self.send_response(200)
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    with outer.cond:
                        cursor = len(outer.events)
                    try:
                        while not outer.closed:
                            with outer.cond:
                                outer.cond.wait_for(
                                    lambda: len(outer.events) > cursor or
                                    outer.closed, timeout=0.5)
                                batch = outer.events[cursor:]
                                cursor = len(outer.events)
                            for ev in batch:
                                data = (json.dumps(ev) + "\n").encode()
                                self.wfile.write(b"%x\r\n" % len(data) +
                                                 data + b"\r\n")
                                self.wfile.flush()
                    except OSError:
                        pass
                    self.close_connection = True
                    return
                with outer.cond:
                    containers = dict(outer.containers)
                if self.path.startswith("/containers/json"):
                    self._json(200, [{"Id": cid, "Names": [f"/{c['name']}"],
                                      "Labels": c["labels"]}
                                     for cid, c in containers.items()])
                    return
                c = containers.get(self.path.split("/")[2])
                if c is None:
                    self._json(404, {"message": "no such container"})
                else:
                    self._json(200, {"Id": self.path.split("/")[2],
                                     "Name": f"/{c['name']}",
                                     "Config": {"Labels": c["labels"]}})

        class Server(socketserver.ThreadingUnixStreamServer):
            daemon_threads = True

        self.closed = False
        self._srv = Server(path, Handler)
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True, name="mini-dockerd")
        self._thread.start()

    def start(self, cid: str, name: str, labels: dict) -> None:
        with self.cond:
            self.containers[cid] = {"name": name, "labels": labels}
            self.events.append({"Type": "container", "Action": "start",
                                "Actor": {"ID": cid, "Attributes": labels}})
            self.cond.notify_all()

    def die(self, cid: str) -> None:
        with self.cond:
            self.containers.pop(cid, None)
            self.events.append({"Type": "container", "Action": "die",
                                "Actor": {"ID": cid, "Attributes": {}}})
            self.cond.notify_all()

    def shutdown(self) -> None:
        with self.cond:
            self.closed = True
            self.cond.notify_all()
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=5)
        with contextlib.suppress(OSError):
            os.unlink(self.path)


def hostint_slots(d, state) -> list:
    """[(table slot, IPv4)] of the node's pods, in ``state``'s order."""
    return [(d.endpoints.lookup(cni_mod._endpoint_id_for(
        hostint_cid(f"pod-{ep_id}"))).table_slot, ip)
        for ep_id, ip, _l in state.endpoints]


def hostint_batch(state, remotes, objs, slot_of, rows: int):
    """(packed [10, rows], {VIP row: its backends}): ``policy_packets``
    on the agent's slots, the last ``HOSTINT_VIP_ROWS`` to service
    VIPs."""
    packed, _ = policy_packets(state, remotes, rows)
    packed = retarget(packed, [slot for slot, _ip in slot_of])
    return packed, vip_rows(packed, objs, slot_of)


def identity_keys(d) -> dict:
    """{label set's sha256: identity} of ``d``'s allocator."""
    return {i.labels.sha256_sum(): i.id
            for i in d.identity_allocator.snapshot_identities()}


def rename_by_keys(a, keys: dict) -> dict:
    """{identity on ``a``: the one ``keys`` gives its labels}."""
    return {i.id: keys[i.labels.sha256_sum()]
            for i in a.identity_allocator.snapshot_identities()
            if i.labels.sha256_sum() in keys}


def hostint_twin(state, objs, now: int, ct_slots: int, rows: int) -> dict:
    """The twin B (a worker process, on the CPU, so its builds overlap
    agent A's): ``hostint_feed_twin``, ``rows`` rows at ``now`` from an
    empty conntrack table and zeroed counters, then the front ends
    (``front_ends``).  Its outputs and buffers, redirects, map states,
    identities by labels and slots."""
    AGENT_STATE_ROOT.mkdir(parents=True, exist_ok=True)
    sdir = tempfile.mkdtemp(prefix="hostint-twin-", dir=AGENT_STATE_ROOT)
    b = srv = None
    try:
        b, srv, _ = start_agent(torch.device("cpu"), sdir, ct_slots)
        t0 = time.perf_counter()
        hostint_feed_twin(b, srv.base_url, objs, state)
        if not hostint_settled(b):
            raise RuntimeError("the twin did not settle")
        twin_s = time.perf_counter() - t0
        slot_of = hostint_slots(b, state)
        remotes = policy_remotes(state)
        packed, _vips = hostint_batch(state, remotes, objs, slot_of, rows)
        b.datapath.counters.packets.zero_()
        b.datapath.counters.bytes.zero_()
        outs = policy_outputs(b, b.datapath.process_packed(
            torch.as_tensor(packed), now=now))
        return {"twin_s": twin_s, "slot_of": slot_of, "outputs": outs,
                "redirects": {x.id: x.proxy_port
                              for x in b.proxy.redirects()},
                "states": policy_map_states(b),
                "identities": identity_keys(b),
                "fronts": front_ends(torch.device("cpu"), b, srv.base_url,
                                     state, remotes, now)}
    finally:
        if srv is not None:
            srv.shutdown()
        if b is not None:
            b.shutdown()
        shutil.rmtree(sdir, ignore_errors=True)


def k8s_sync(a, url, fake, objs, state) -> dict:
    """The watcher and its transport on agent ``a``, as a node starts:
    the apiserver holds every object but the Services, which are
    created once the first sync is in (the watcher programs a service's
    backends only on its Service event, as the reference's does); then
    the node's pods arrive one after another through CNI ADD, as kubelet
    runs them once the agent has synced (each rule a CNP makes is one
    policy import, and with endpoints present every import waits for
    their regeneration, O(rules^2) at 1,000 rules).  The local identity
    allocator regenerates nothing when a later pod's identity appears
    (the reference's ``_on_identity_change`` runs for the kvstore
    allocators only, ROADMAP §3), so an endpoint built before it misses
    it: after the pods, one ``trigger_policy_updates`` round rebuilds
    every endpoint with every identity.  Reported: seconds from
    ``start()`` to every endpoint ready with the services, the tunnel
    map and the ipcache on the card, the round's seconds, and the
    map-state entries it changed (what the pods' first builds had
    missed)."""
    watcher = K8sWatcher(a)
    t0 = time.perf_counter()
    transport = K8sTransport(watcher, fake.base_url).start()
    if not transport.wait_synced(HOSTINT_WAIT_S) or \
            not watcher.wait_idle(HOSTINT_WAIT_S):
        raise AssertionError("hostint: the first sync did not finish")
    synced_s = time.perf_counter() - t0
    for svc in objs["services"]:
        fake.upsert("services", svc)
    wait_until(lambda: watcher.events_by_kind.get("service", 0) >=
               len(objs["services"]), "the Service events",
               HOSTINT_WAIT_S)
    if not watcher.wait_idle(HOSTINT_WAIT_S):
        raise AssertionError("hostint: the Service events did not apply")
    services_s = time.perf_counter() - t0 - synced_s
    t_pods = time.perf_counter()
    hostint_cni_pods(url, state)
    if not hostint_settled(a):
        raise AssertionError("hostint: the agent did not settle")
    pods_s = time.perf_counter() - t_pods
    before = policy_map_states(a)
    t_round = time.perf_counter()
    a.trigger_policy_updates("identity-change")
    if not hostint_settled(a):
        raise AssertionError("hostint: the identity round did not settle")
    round_s = time.perf_counter() - t_round
    after = policy_map_states(a)
    stale = sum(len(set(before.get(k, {}).items()) ^
                    set(after.get(k, {}).items()))
                for k in set(before) | set(after))
    return {"watcher": watcher, "transport": transport,
            "first_sync_s": synced_s, "services_s": services_s,
            "pods_s": pods_s, "identity_round_s": round_s,
            "stale_entries_before_round": stale,
            "sync_s": time.perf_counter() - t0}


def hostint_cni_pods(url, state) -> None:
    """The node's pods through CNI ADD against the agent at ``url``."""
    for ep_id, ip, labels in state.endpoints:
        cni_mod.cni_add(Client(url), hostint_cid(f"pod-{ep_id}"),
                        config={"ip": ip,
                                "labels": hostint_cni_config(labels)})


def hostint_card_entries(a, objs, eps) -> dict:
    """What the card's tables hold of the apiserver's objects: the pod
    CIDRs in the tunnel LPM (to their nodes), the pods in the ipcache LPM
    (local ones to their endpoints' identities, remote ones unmanaged),
    the services in the LB."""
    cidrs = [n["spec"]["podCIDR"] for n in objs["nodes"]]
    probe = [str(ipaddress.ip_network(c)[7]) for c in cidrs]
    node_ips = np.array([np.uint32(int(ipaddress.IPv4Address(
        n["status"]["addresses"][0]["address"]))).view(np.int32)
        for n in objs["nodes"]])
    tunnel_ok = int((card_lpm(a.datapath, "tunnel", probe) ==
                     node_ips).sum())
    pod_ips = [p["status"]["podIP"] for p in objs["pods"]]
    want = np.array([eps[ip].security_identity if ip in eps
                     else RESERVED_UNMANAGED for ip in pod_ips], np.int32)
    ipcache_ok = int((card_lpm(a.datapath, "ipcache", pod_ips) ==
                      want).sum())
    lb = {(s.vip, s.port): len(s.backends) for s in a.datapath.lb.services()}
    lb_ok = sum(lb.get((ipv4_to_u32(s["spec"]["clusterIP"]),
                        s["spec"]["ports"][0]["port"])) == HOSTINT_BACKENDS
                for s in objs["services"])
    return {"tunnel_on_card": tunnel_ok, "pods_on_card": ipcache_ok,
            "services_in_lb": lb_ok, "lb_entries": len(lb),
            "nodes": len(cidrs), "pods": len(pod_ips),
            "services": len(objs["services"])}


def k8s_propagation(dev) -> dict:
    """CNP upserts and deletes through a fake apiserver into an agent
    on the card at ``policy_propagation``'s state (100 rules, so the
    times compare with that leg's): each timed from
    ``FakeAPIServer.upsert`` / ``delete`` to the batch in which the flow
    the CNP opens or closes flips."""
    base = policy_state(*HOSTINT_PROPAGATION)
    scoped = lambda labels: tuple(labels) + (  # noqa: E731
        f"k8s:io.kubernetes.pod.namespace={HOSTINT_NS}",)
    state = dataclasses.replace(
        base, endpoints=[(e, ip, scoped(lb)) for e, ip, lb in base.endpoints],
        peers=[(ip, scoped(lb)) for ip, lb in base.peers])
    fake = FakeAPIServer(history_limit=1 << 16).start()
    sdir = tempfile.mkdtemp(prefix="hostint-prop-", dir=AGENT_STATE_ROOT)
    d = srv = watcher = transport = None
    samples = []
    try:
        d, srv, _ = start_agent(dev, sdir, HOSTINT_CT_SLOTS)
        for i, rule in enumerate(json.loads(state.rules_json)):
            fake.upsert("ciliumnetworkpolicies", {
                "metadata": {"name": f"cnp-{i}", "namespace": HOSTINT_NS},
                "spec": rule})
        watcher = K8sWatcher(d)
        transport = K8sTransport(watcher, fake.base_url).start()
        if not transport.wait_synced(HOSTINT_WAIT_S) or \
                not watcher.wait_idle(HOSTINT_WAIT_S):
            raise AssertionError("hostint: the propagation CNPs did not "
                                 "sync")
        # the workloads after the policies, as in k8s_sync, and the
        # same trigger_policy_updates round after them: the endpoints
        # built before the later identities existed rebuild with them
        for ep_id, ip, labels in state.endpoints:
            d.endpoint_create(ep_id, ipv4=ip, labels=list(labels))
        for ip, labels in state.peers:
            ident, _ = d.identity_allocator.allocate(
                Labels.from_model(list(labels)))
            d.ipcache.upsert(ip, ident.id, SOURCE_KVSTORE)
        d.trigger_policy_updates("identity-change")
        if not hostint_settled(d):
            raise AssertionError("hostint: the propagation agent did not "
                                 "settle")
        batch, _ = policy_packets(state, policy_remotes(state),
                                  POLICY_PROBE_BATCH, seed=21)
        rows = {f: PACKED_FIELDS.index(f) for f in PACKED_FIELDS}
        sport = iter(range(1 << 30))
        for k, (i, j, port, rule_dict) in enumerate(
                policy_probes(d, state, HOSTINT_CHANGES)):
            ep_id, ep_ip, _l = state.endpoints[i]
            for f, v in (("endpoint", d.endpoints.lookup(ep_id).table_slot),
                         ("dport", port), ("proto", 6), ("direction", 0),
                         ("tcp_flags", conntrack.TCP_SYN),
                         ("saddr", int(ipaddress.IPv4Address(
                             state.peers[j][0]))),
                         ("daddr", int(ipaddress.IPv4Address(ep_ip)))):
                batch[rows[f], 0] = np.uint32(v).view(np.int32)

            def serve() -> int:
                batch[rows["sport"], 0] = 1024 + next(sport) % 64000
                v, _e, _i, _n = d.datapath.process_packed(
                    torch.as_tensor(batch, device=dev), now=POLICY_NOW)
                return int(v[0])

            if serve() >= 0:
                raise AssertionError(f"hostint: probe {k} is allowed before "
                                     "its CNP")
            name = f"probe-{k}"
            for change in ("add", "delete"):
                t0 = time.perf_counter()
                if change == "add":
                    fake.upsert("ciliumnetworkpolicies", {
                        "metadata": {"name": name, "namespace": HOSTINT_NS},
                        "spec": rule_dict})
                else:
                    fake.delete("ciliumnetworkpolicies", HOSTINT_NS, name)
                batches = 0
                while True:
                    batches += 1
                    if (serve() >= 0) == (change == "add"):
                        flip = time.perf_counter() - t0
                        break
                    if time.perf_counter() - t0 > HOSTINT_WAIT_S:
                        raise AssertionError(
                            f"hostint: probe {k}'s {change} did not reach "
                            "the card")
                    time.sleep(0.001)
                if not watcher.wait_idle(HOSTINT_WAIT_S) or \
                        not hostint_settled(d):
                    raise AssertionError("hostint: propagation agent did "
                                         "not settle")
                samples.append({"change": change, "flip_s": flip,
                                "batches": batches})
        status = watcher.get_cnp_status(HOSTINT_NS, "cnp-0")
    finally:
        if transport is not None:
            transport.stop()
        if watcher is not None:
            watcher.stop()
        if srv is not None:
            srv.shutdown()
        if d is not None:
            d.shutdown()
        fake.shutdown()
        shutil.rmtree(sdir, ignore_errors=True)

    def pct(which):
        xs = [s["flip_s"] for s in samples if s["change"] in which]
        return {"p50": float(np.percentile(xs, 50)),
                "p99": float(np.percentile(xs, 99)), "samples": len(xs)}

    return {"state": dict(zip(("rules", "endpoints", "peers", "cidrs"),
                              HOSTINT_PROPAGATION)),
            "flip_s": pct(("add", "delete")), "add_flip_s": pct(("add",)),
            "delete_flip_s": pct(("delete",)),
            "cnp_status_enforcing": all(s.get("enforcing")
                                        for s in status.values()),
            "samples": samples}


FRONT_ENDS = ("cni", "libnetwork", "workload", "docker")


def k8s_relist(a, fake, sync, state, remotes, slot_of, now) -> dict:
    """``compact()`` and ``disconnect_watchers()`` under agent ``a``'s
    transport: the reflectors behind the compaction relist, the
    resourceVersion dedup skips what they re-deliver, and rows keep their
    verdicts from the same CT state."""
    watcher, reflectors = sync["watcher"], sync["transport"].reflectors
    held, _ = policy_packets(state, remotes, HOSTINT_RELIST_ROWS, seed=22)
    held = torch.as_tensor(retarget(held, [s for s, _ip in slot_of]),
                           device=a.datapath.device)
    snap = a.datapath.snapshot_ct()
    before = [t.cpu().numpy() for t in
              a.datapath.process_packed(held, now=now)[:3]]
    # a watch from the newest version is not compacted away: a marker
    # namespace gives that version to the namespaces reflector alone, so
    # every other reflector's version falls behind the compaction
    seen_ns = watcher.events_by_kind.get("namespace", 0)
    fake.upsert("namespaces", {"metadata": {"name": "relist-marker"}})
    wait_until(lambda: watcher.events_by_kind.get("namespace", 0) >
               seen_ns, "the marker namespace", HOSTINT_WAIT_S)
    if not watcher.wait_idle(HOSTINT_WAIT_S):
        raise AssertionError("hostint: the marker did not apply")
    applied = watcher.events_processed
    behind = [r for r in reflectors if r.kind != "namespace"]
    marker = [r for r in reflectors if r.kind == "namespace"][0]
    relists = [r.relists for r in behind]
    # a reflector counts a relist before it feeds the listed objects and
    # swaps in its new ``_known`` after: the swap says it has fed them all
    known = [r._known for r in behind]
    rewatches = marker.rewatches
    skipped = [0]
    enqueue = watcher.enqueue_event

    def counting(kind, action, obj, retries=0):
        fresh = enqueue(kind, action, obj, retries)
        skipped[0] += not fresh
        return fresh

    watcher.enqueue_event = counting
    try:
        t0 = time.perf_counter()
        fake.compact()
        fake.disconnect_watchers()
        wait_until(lambda: all(r.relists > n and r._known is not k
                               for r, n, k in zip(behind, relists, known))
                   and marker.rewatches > rewatches,
                   "the relists", HOSTINT_WAIT_S)
        if not watcher.wait_idle(HOSTINT_WAIT_S) or not hostint_settled(a):
            raise AssertionError("hostint: the relist did not settle")
        relist_s = time.perf_counter() - t0
    finally:
        watcher.enqueue_event = enqueue
    a.datapath.restore_ct_snapshots(*snap)
    after = [t.cpu().numpy() for t in
             a.datapath.process_packed(held, now=now)[:3]]
    return {"rows": int(held.shape[1]),
            "mismatches": {k: int((x != y).sum()) for k, x, y in
                           zip(("verdict", "event", "identity"), before,
                               after)},
            "objects_relisted": sum(len(r._known) for r in behind),
            "dedup_skipped": skipped[0],
            "events_applied": watcher.events_processed - applied,
            "relists": {r.kind: r.relists for r in reflectors},
            "rewatches": {r.kind: r.rewatches for r in reflectors},
            "relist_s": relist_s}


def front_ends(dev, d, url, state, remotes, now, dockerd=None) -> dict:
    """Endpoints made by the container front ends on agent ``d``: a CNI
    ADD; a docker libnetwork RequestAddress / CreateEndpoint / Join
    over the plugin's HTTP; a ``WorkloadWatcher`` start event; and a
    container start, through a ``DockerEventWatcher`` following
    ``dockerd`` where one is given, else as the start event that
    watcher would hand its sink.  Each endpoint's rows, then CNI DEL,
    Leave, the stop and die events, and the rows again; both passes
    from the CT state before the first, so every row is a new flow."""
    client = Client(url)
    cid, wl_cid = hostint_cid("cni-new"), hostint_cid("wl")
    dcid = hostint_cid("docker-ev")
    sink = runtime_watch.WorkloadWatcher(d, ipam=d.ipam, label_prefix="k8s")
    watcher = ps = None
    made, out = {}, {}
    try:
        if dockerd is not None:
            # following the dockerd from the start: its first sync would
            # stop a container the dockerd does not hold
            watcher = runtime_watch.DockerEventWatcher(
                runtime_watch.DockerClient(dockerd.path), sink,
                backoff_base=0.02, backoff_max=0.2).start()
            if not watcher.synced.wait(60):
                raise AssertionError("hostint: the docker watcher did not "
                                     "sync")
        out["cni_result"] = cni_mod.cni_add(client, cid, config={
            "ip": HOSTINT_NEW_IP,
            "labels": hostint_cni_config(state.endpoints[0][2])})
        made["cni"] = cni_mod._endpoint_id_for(cid)
        ps = docker_plugin.PluginServer(docker_plugin.LibnetworkDriver(
            client, wait_tries=3)).start()
        code, addr = _plugin_post(ps.base_url, "IpamDriver.RequestAddress",
                                  {"PoolID": "CiliumPoolv4"})
        eid = "dockerep-" + hostint_cid("lib")[:24]
        out["libnetwork_codes"] = [code] + [_plugin_post(
            ps.base_url, method, body)[0] for method, body in (
            ("NetworkDriver.CreateEndpoint", {
                "NetworkID": "net-1", "EndpointID": eid,
                "Interface": {"Address": addr["Address"]}}),
            ("NetworkDriver.Join", {"EndpointID": eid}))]
        made["libnetwork"] = docker_plugin.endpoint_id_for(eid)
        made["workload"] = sink.on_start({
            "id": wl_cid, "name": "wl-1",
            "labels": HOSTINT_CONTAINER_LABELS})
        if dockerd is not None:
            dockerd.start(dcid, "ev-1", HOSTINT_CONTAINER_LABELS)
            wait_until(lambda: sink.endpoint_of(dcid) is not None,
                       "the docker start event", HOSTINT_WAIT_S)
            made["docker"] = sink.endpoint_of(dcid)
        else:
            made["docker"] = sink.on_start({
                "id": dcid, "name": "ev-1",
                "labels": HOSTINT_CONTAINER_LABELS})
        if not hostint_settled(d):
            raise AssertionError("hostint: front-end endpoints not built")
        slots = {}
        for fe in FRONT_ENDS:
            ep = d.endpoints.lookup(made[fe])
            if ep is None:
                raise AssertionError(f"hostint: no {fe} endpoint")
            slots[fe] = (ep.table_slot, ep.ipv4)
        snap = d.datapath.snapshot_ct()

        def rows(first_seed: int) -> dict:
            d.datapath.restore_ct_snapshots(*snap)
            got = {}
            for k, fe in enumerate(FRONT_ENDS):
                pk = outage_packets(state, remotes, *slots[fe],
                                    seed=first_seed + k)
                got[fe] = [t.cpu().numpy() for t in d.datapath.process_packed(
                    torch.as_tensor(pk, device=dev), now=now)[:3]]
            return got

        out.update(made=made, slots=slots, created=rows(40),
                   redirects={x.id: x.proxy_port
                              for x in d.proxy.redirects()},
                   identities=identity_keys(d))
        # tear down through the same front ends
        if dockerd is not None:
            dockerd.die(dcid)
            wait_until(lambda: sink.endpoint_of(dcid) is None,
                       "the docker die event", HOSTINT_WAIT_S)
        else:
            sink.on_stop(dcid)
        cni_mod.cni_del(client, cid)
        _plugin_post(ps.base_url, "NetworkDriver.Leave", {"EndpointID": eid})
        _plugin_post(ps.base_url, "IpamDriver.ReleaseAddress",
                     {"Address": addr["Address"].split("/")[0]})
        sink.on_stop(wl_cid)
        if not hostint_settled(d):
            raise AssertionError("hostint: deletes did not settle")
        out["deleted"] = rows(60)
        out["left"] = [fe for fe in FRONT_ENDS
                       if d.endpoints.lookup(made[fe]) is not None]
    finally:
        if watcher is not None:
            watcher.stop()
        if ps is not None:
            ps.shutdown()
    return out


def front_end_gap(got: dict, twin: dict) -> dict:
    """``front_ends`` of agent A against the twin's: ids and slots, and
    for each pass and front end the rows A allowed and the elements in
    which verdict, event and identity differ (the twin's proxy ports
    renamed by redirect id, A's identities by labels)."""
    ports = np.arange(PROXY_PORT_MAX + 1, dtype=np.int32)
    for rid, port in twin["redirects"].items():
        ports[port] = got["redirects"].get(rid, port)
    rename = {i: twin["identities"][k] for k, i in got["identities"].items()
              if k in twin["identities"]}
    out = {"ids_and_slots_equal": got["made"] == twin["made"] and
           got["slots"] == twin["slots"],
           "endpoints_left": {"a": got["left"], "b": twin["left"]},
           "cni_result": got["cni_result"],
           "libnetwork_codes": got["libnetwork_codes"]}
    for stage in ("created", "deleted"):
        out[stage] = {}
        for fe in FRONT_ENDS:
            (va, ea, ia), (vb, eb, ib) = got[stage][fe], twin[stage][fe]
            vb = np.where(vb > 0, ports[np.clip(vb, 0, PROXY_PORT_MAX)], vb)
            out[stage][fe] = {
                "allowed": int((va >= 0).sum()), "rows": int(va.size),
                "mismatches": int((va != vb).sum() + (ea != eb).sum() +
                                  (rename_ids(ia, rename) != ib).sum())}
    return out


def _plugin_post(base: str, method: str, body=None):
    """(HTTP status, decoded JSON) of one libnetwork call."""
    req = urllib.request.Request(f"{base}/{method}", method="POST",
                                 data=json.dumps(body or {}).encode())
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def hostint_health(dev, a) -> dict:
    """``HealthProber`` over the agent's nodes, ICMPv6 through the card:
    ``HOSTINT_PROBED`` nodes and this one get an engine on the card
    serving their v6 address (the agent's own engine serves this
    node's), the rest none; then TCP probes against a responder that
    then shuts down."""
    nodes = [(n.full_name, n.get_node_ip(ipv6=True))
             for n in a.node_manager.nodes()]
    local = (f"{a.config.cluster_name}/{a.node_name}", HOSTINT_LOCAL[1])
    a.datapath.set_router_ip6(HOSTINT_LOCAL[1])
    engines = {HOSTINT_LOCAL[1]: a.datapath}
    t0 = time.perf_counter()
    for _name, ip in nodes[:HOSTINT_PROBED]:
        e = engine.Datapath(ct_slots=1 << 10, device=dev)
        e.telemetry_enabled = False
        e.load_policy([PolicyMapState()], revision=1)
        e.set_router_ip6(ip)
        engines[ip] = e
    engines_s = time.perf_counter() - t0
    probe = health.make_icmp6_probe(engines, "fd00:10::ffff")
    prober = health.HealthProber(lambda: nodes + [local], probe_fn=probe,
                                 interval=3600)
    try:
        t0 = time.perf_counter()
        prober.probe_once()
        sweep_s = time.perf_counter() - t0
        st = prober.status()
    finally:
        prober.shutdown()
    reachable = sorted(n for n, s in st.items() if s["healthy"])
    want = sorted([n for n, _ip in nodes[:HOSTINT_PROBED]] + [local[0]])
    lat = [s["latency-seconds"]["icmp"] * 1e3 for n, s in st.items()
           if s["healthy"]]
    responder = health.HealthResponder().start()
    tcp = health.HealthProber(lambda: [("tcp/self", "127.0.0.1")],
                              probe_fn=health.make_tcp_probe(
                                  lambda _ip: responder.port, timeout=2.0),
                              interval=3600)
    try:
        tcp.probe_once()
        up = tcp.status()["tcp/self"]["healthy"]
        responder.shutdown()
        tcp.probe_once()
        down = tcp.status()["tcp/self"]["healthy"]
    finally:
        tcp.shutdown()
    return {"nodes": len(nodes) + 1, "programmed": len(engines),
            "reachable": len(reachable),
            "reachable_are_programmed": reachable == want,
            "unreachable": len(st) - len(reachable),
            "icmp6_ms_per_probe": {"p50": float(np.median(lat)),
                                   "max": float(np.max(lat)),
                                   "samples": len(lat)},
            "sweep_s": sweep_s, "engines_s": engines_s,
            "tcp_up": up, "tcp_after_shutdown": down}


def hostint_bugtool(a, url) -> dict:
    """``collect_remote`` against the agent's REST API and ``collect``
    in process: the archives' members, and the card named in
    ``status.json``."""
    import tarfile
    out = {}
    tmp = tempfile.mkdtemp(prefix="bugtool-", dir=AGENT_STATE_ROOT)
    try:
        for how, path in (("remote", bugtool.collect_remote(
                Client(url), os.path.join(tmp, "r.tgz"))),
                          ("local", bugtool.collect(
                              a, os.path.join(tmp, "l.tgz")))):
            with tarfile.open(path) as tar:
                names = sorted(os.path.basename(m.name)
                               for m in tar.getmembers())
                status = json.load(tar.extractfile(
                    [m for m in tar.getmembers()
                     if m.name.endswith("/status.json")][0]))
            out[how] = {"members": names,
                        "failed": [n for n in names if n.endswith(".failed")],
                        "device_kind": status["features"]["device_kind"],
                        "bytes": os.path.getsize(path)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def hostint_packing(dev, state4) -> dict:
    """The packing manifest on the card: the full-width v4 and v6
    serving tables packed; the views equal to the leaves; a v4 step on
    the views against the step on the tables at 2**20 rows, each from
    the same CT state; policy rows written by ``refresh_policy`` and by
    ``make_policy_row_writer`` into the packed buffer."""
    dp = engine.Datapath(ct_slots=HOSTINT_PACK_CT, device=dev)
    dp.telemetry_enabled = False
    state4.load(dp)
    v6_of(state4).load(dp)
    out = {}
    for fam, tables in (("v4", dp._tables), ("v6", dp._tables6)):
        m = packing.build_manifest(tables)
        bufs = packing.pack_groups(tables, m)
        views = packing.unpacker(m)(bufs)
        leaves, got = dict(packing._walk(tables)), dict(packing._walk(views))
        out[fam] = {"groups": [list(g) for g in m.groups],
                    "leaves": m.leaf_count(),
                    "bytes": int(sum(b.numel() * b.element_size()
                                     for b in bufs)),
                    "view_mismatches": sum(
                        int((leaves[p] != got[p]).sum()) for p in leaves),
                    "views_in_buffers": all(
                        got[l.path].data_ptr() ==
                        bufs[m.group_names().index(l.group)].data_ptr() +
                        4 * l.offset for l in m.leaves if l.size)}
        if fam == "v4":
            m4, views4 = m, views
    batch = torch.as_tensor(next(v4_serving_packets(state4, HOSTINT_BATCH,
                                                    seed=41)), device=dev)
    snap = dp.snapshot_ct()
    counters = dp._counters.clone()
    original = dp._tables
    want = [t.cpu().numpy() for t in dp.process_packed(batch, now=V4_T0)[:3]]
    # the discard slot N+1 takes every dropped write in no set order:
    # the real slots and the sentinel are compared
    want_ct = dp.ct.state.cpu().numpy()
    dp.restore_ct_snapshots(*snap)
    dp._counters.copy_(counters)
    dp._tables = views4
    try:
        got = [t.cpu().numpy() for t in dp.process_packed(batch,
                                                          now=V4_T0)[:3]]
    finally:
        dp._tables = original
    out["step_on_views"] = {
        "rows": int(batch.shape[1]),
        "mismatches": {k: int((w != g).sum()) for k, w, g in
                       zip(("verdict", "event", "identity"), want, got)},
        "ct_mismatches": int((dp.ct.state.cpu().numpy() != want_ct)[
            :, :dp.ct.slots + 1].sum()),
        "allowed_share": float((want[0] >= 0).mean())}
    del dp

    # refresh_policy's row writes and the packed row writer
    mgr = DeviceTableManager(initial_endpoints=len(state4.states),
                             device=dev)
    tm = engine.Datapath(ct_slots=1 << 10, device=dev)
    for k, st in enumerate(state4.states):
        mgr.attach(100 + k)
        mgr.sync_endpoint(100 + k, st, revision=1)
    tm.use_table_manager(mgr, ipcache_prefixes=state4.prefixes)
    tm.refresh_policy(1)
    m = packing.build_manifest(tm._tables)
    bufs = packing.pack_groups(tm._tables, m)
    writer, g = packing.make_policy_row_writer(m)
    changed = [1, len(state4.states) - 1]
    for k in changed:
        # one entry fewer: a row write, never a growth
        st = PolicyMapState(state4.states[k])
        del st[next(iter(st))]
        if mgr.sync_endpoint(100 + k, st, revision=2)["full_swap"]:
            raise AssertionError("hostint: a smaller row grew the tables")
    slots = [mgr.slot_of(100 + k) for k in changed]
    rows = [r[slots] for r in mgr.host_mirror()]
    before = tm.pack_stats()["row-writes"]
    rebuilt = tm.refresh_policy(2)
    writer(bufs[g], torch.as_tensor(np.array(slots), device=dev),
           *(torch.as_tensor(r, device=dev) for r in rows))
    views = packing.unpacker(m)(bufs)
    out["row_writer"] = {
        "rows": len(slots), "rebuilt": rebuilt,
        "row_writes": tm.pack_stats()["row-writes"] - before,
        "mismatches": sum(int((getattr(views.datapath, f) !=
                               getattr(tm._tables.datapath, f)).sum())
                          for f in ("key_id", "key_meta", "value"))}
    return out


# the module settings the worker legs read, handed over from the parent
# (a spawned worker imports this module afresh)
HOSTINT_WORKER_KNOBS = ("HOSTINT_PROPAGATION", "HOSTINT_CHANGES",
                        "HOSTINT_CT_SLOTS", "HOSTINT_WAIT_S",
                        "HOSTINT_PACK_CT", "HOSTINT_BATCH",
                        "POLICY_PROBE_BATCH", "V4_STATE")


def hostint_worker_legs(dev, knobs: dict) -> dict:
    """The legs with tables of their own, in a worker process beside
    ``k8s-sync`` (their seconds would otherwise add to the phase's):
    ``k8s_propagation``, then ``hostint_packing`` on the v4 serving
    state ``phase_v4`` serves, with the parent's ``knobs``.  Their
    results, seconds, and the dense kernel's launches in the worker."""
    globals().update(knobs)
    dv.dense_verdict.launches = 0
    t0 = time.perf_counter()
    prop = k8s_propagation(dev)
    prop_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    packed = hostint_packing(dev, v4_serving_state(**V4_STATE))
    return {"propagation": prop, "propagation_s": prop_s,
            "packing": packed, "packing_s": time.perf_counter() - t0,
            "launches": dv.dense_verdict.launches}


def phase_hostint(dev) -> int:
    """The host integrations over the agent on the card; returns the
    dense kernel's launches on the path (the agents serve on the hash
    engine)."""
    t_phase = time.perf_counter()
    state = policy_state(*HOSTINT_STATE)
    objs = hostint_objects(state)
    remotes = policy_remotes(state)
    # a batch time ahead of the wall clock: the agents' ct-gc controller
    # (wall clock) keeps every entry the batches create
    now = int(time.time()) + HOSTINT_NOW_AHEAD_S
    AGENT_STATE_ROOT.mkdir(parents=True, exist_ok=True)
    sdir = tempfile.mkdtemp(prefix="hostint-", dir=AGENT_STATE_ROOT)
    fake = FakeAPIServer(history_limit=1 << 16).start()
    a = srv_a = None
    sync = {}
    dv.dense_verdict.launches = 0
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        twin_job = pool.apply_async(hostint_twin, (
            state, objs, now, HOSTINT_CT_SLOTS, HOSTINT_BATCH))
        legs_job = pool.apply_async(hostint_worker_legs, (dev, {
            k: globals()[k] for k in HOSTINT_WORKER_KNOBS}))
        try:
            a, srv_a, _ = start_agent(dev, sdir, HOSTINT_CT_SLOTS)
            for kind, resource in (("namespaces", "namespaces"),
                                   ("cnps", "ciliumnetworkpolicies"),
                                   ("nps", "networkpolicies"),
                                   ("pods", "pods"), ("nodes", "nodes"),
                                   ("endpoints", "endpoints")):
                for obj in objs[kind]:
                    fake.upsert(resource, obj)

            # ---- k8s-sync: the apiserver into A; the twin B, fed by
            # hand on the CPU meanwhile; one batch through both ----
            sync = k8s_sync(a, srv_a.base_url, fake, objs, state)
            watcher = sync["watcher"]
            eps = {e.ipv4: e for e in a.endpoints.endpoints()}
            entries = hostint_card_entries(a, objs, eps)
            slot_of = hostint_slots(a, state)
            packed, vip_want = hostint_batch(state, remotes, objs, slot_of,
                                             HOSTINT_BATCH)
            t0 = time.perf_counter()
            twin = twin_job.get(timeout=2 * HOSTINT_WAIT_S)
            twin_wait_s = time.perf_counter() - t0
            if twin["slot_of"] != slot_of:
                raise AssertionError("hostint: the agents' slots differ")
            a.datapath.counters.packets.zero_()
            a.datapath.counters.bytes.zero_()
            rename = rename_by_keys(a, twin["identities"])
            got = policy_outputs(a, a.datapath.process_packed(
                torch.as_tensor(packed, device=dev), now=now), rename=rename)
            parity, ports_renamed = policy_twin_mismatches(
                got, twin, {x.id: x.proxy_port for x in a.proxy.redirects()},
                policy_map_states(a, rename))
            vip_bad = sum(int(got["nat.daddr"][r]) not in want
                          for r, want in vip_want.items())
            emit("k8s-sync", **entries,
                 rules=len(objs["cnps"]) + len(objs["nps"]),
                 cnps=len(objs["cnps"]), network_policies=len(objs["nps"]),
                 endpoints=len(state.endpoints),
                 endpoints_ready=sum(e.state == "ready" and
                                     e.policy_revision == a.repo.revision
                                     for e in a.endpoints.endpoints()),
                 first_sync_s=sync["first_sync_s"],
                 services_s=sync["services_s"], pods_s=sync["pods_s"],
                 identity_round_s=sync["identity_round_s"],
                 stale_entries_before_round=sync[
                     "stale_entries_before_round"],
                 k8s_sync_s=sync["sync_s"],
                 twin_s=twin["twin_s"], twin_wait_s=twin_wait_s,
                 events=dict(watcher.events_by_kind),
                 cnp_status_enforcing=sum(
                     s.get("enforcing", False) for nodes in
                     watcher.cnp_status.values() for s in nodes.values()),
                 rows=int(packed.shape[1]), vs_twin=parity,
                 ports_renamed=ports_renamed,
                 identities_renamed=sum(k != v for k, v in rename.items()),
                 vip_rows=len(vip_want), vip_rows_not_to_a_backend=vip_bad,
                 allowed_share=float((got["verdict"] >= 0).mean()),
                 name_power_limit=nvidia_smi("name,power.limit"))

            # ---- k8s-relist: compaction and dropped streams ----
            relist = k8s_relist(a, fake, sync, state, remotes, slot_of, now)
            emit("k8s-relist", **relist)

            # ---- cni-docker: the container front ends ----
            t0 = time.perf_counter()
            sock_dir = tempfile.mkdtemp(prefix="dk", dir=AGENT_STATE_ROOT)
            # a unix socket path is capped at about 100 bytes
            dockerd = MiniDockerd(os.path.relpath(
                os.path.join(sock_dir, "d.sock")))
            try:
                fronts = front_end_gap(front_ends(
                    dev, a, srv_a.base_url, state, remotes, now, dockerd),
                    twin["fronts"])
            finally:
                dockerd.shutdown()
                shutil.rmtree(sock_dir, ignore_errors=True)
            emit("cni-docker", **fronts, seconds=time.perf_counter() - t0)

            # ---- health: ICMPv6 through the card's v6 step, and TCP ----
            t0 = time.perf_counter()
            probes = hostint_health(dev, a)
            emit("health", **probes, seconds=time.perf_counter() - t0,
                 name_power_limit=nvidia_smi("name,power.limit"))

            # ---- bugtool ----
            t0 = time.perf_counter()
            bug = hostint_bugtool(a, srv_a.base_url)
            emit("bugtool", **bug, seconds=time.perf_counter() - t0)

            # ---- k8s-propagation (policy_propagation's state behind
            # its own apiserver) and packing, from the worker ----
            t0 = time.perf_counter()
            legs = legs_job.get(timeout=2 * HOSTINT_WAIT_S)
            prop, packed_legs = legs["propagation"], legs["packing"]
            emit("k8s-propagation", **prop, seconds=legs["propagation_s"],
                 ran_beside="k8s-sync",
                 name_power_limit=nvidia_smi("name,power.limit"))
            emit("packing", **packed_legs, seconds=legs["packing_s"],
                 worker_wait_s=time.perf_counter() - t0)
        finally:
            if sync:
                sync["transport"].stop()
                sync["watcher"].stop()
            fake.shutdown()
            if srv_a is not None:
                srv_a.shutdown()
            if a is not None:
                a.shutdown()
            shutil.rmtree(sdir, ignore_errors=True)

    launches = dv.dense_verdict.launches + legs["launches"]
    kind = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    counts = [sum(parity.values()), vip_bad,
              entries["tunnel_on_card"] != entries["nodes"],
              entries["pods_on_card"] != entries["pods"],
              entries["services_in_lb"] != entries["services"],
              sum(relist["mismatches"].values()),
              relist["dedup_skipped"] != relist["objects_relisted"],
              relist["events_applied"],
              not fronts["ids_and_slots_equal"],
              any(v["mismatches"] for v in fronts["created"].values()),
              any(v["mismatches"] for v in fronts["deleted"].values()),
              # the libnetwork endpoint carries no k8s label: no CNP or
              # NetworkPolicy selects it and the agent denies its rows
              any(fronts["created"][fe]["allowed"] == 0
                  for fe in ("cni", "workload", "docker")),
              any(v["allowed"] for v in fronts["deleted"].values()),
              any(fronts["endpoints_left"].values()),
              not probes["reachable_are_programmed"],
              probes["unreachable"] != probes["nodes"] - probes["programmed"],
              not probes["tcp_up"], probes["tcp_after_shutdown"],
              any(v["failed"] for v in bug.values()),
              any(v["device_kind"] != kind for v in bug.values()),
              bug["remote"]["members"] != sorted(HOSTINT_REMOTE_MEMBERS),
              packed_legs["v4"]["view_mismatches"],
              packed_legs["v6"]["view_mismatches"],
              not packed_legs["v4"]["views_in_buffers"],
              sum(packed_legs["step_on_views"]["mismatches"].values()),
              packed_legs["step_on_views"]["ct_mismatches"],
              packed_legs["row_writer"]["mismatches"],
              packed_legs["row_writer"]["rebuilt"],
              packed_legs["row_writer"]["row_writes"] != 2,
              not prop["cnp_status_enforcing"]]
    if any(counts):
        raise AssertionError(f"hostint: {counts}")
    emit("hostint", seconds=time.perf_counter() - t_phase,
         hand_kernel_launches={"dense_verdict": launches},
         name_power_limit=nvidia_smi("name,power.limit"))
    return launches


# the members collect_remote archives (cilium_tpu_torch/bugtool.py)
HOSTINT_REMOTE_MEMBERS = (
    "status.json", "policy.json", "endpoints.json", "identities.json",
    "services.json", "prefilter.json", "monitor-stats.json", "config.json",
    "metrics.txt", "hubble-flows.json", "hubble-stats.json", "traces.json",
    "pipeline.json", "flight-recorder.json", "provenance.json")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    feats = probe()
    emit("device", **feats)
    if not feats["hopper"]:
        raise RuntimeError(f"capability {feats['capability']}: the kernels "
                           "are built for sm_90a (Hopper)")

    t0 = time.perf_counter()
    built = kernels.build("dense_verdict")
    emit("build", source="cilium_tpu_torch/csrc/dense_verdict.cu",
         seconds=time.perf_counter() - t0,
         ptxas=[ln.strip() for ln in (built or {"log": ""})["log"]
                .splitlines() if "registers" in ln or "spill" in ln])

    # the bound's operation rate: the kernel's per-pair instructions from
    # its SASS, over the card's lanes for each pipe
    mix = sass_mix.hot_loop_mix(
        kernels.sass("dense_verdict"), "segment_verdict_kernel",
        dv.PACKETS_PER_THREAD)
    clock_hz = float(feats["max_sm_clock"].split()[0]) * 1e6
    pair = sass_mix.pair_seconds(mix["per_pair"], feats["sm_count"],
                                 clock_hz)
    pair_s = pair["seconds"]
    function_pair_s = FUNCTION_COMPARES_PER_PAIR / (
        sass_mix.LANES["alu"] * feats["sm_count"] * clock_hz)
    emit("sass", kernel="dense_verdict", **mix, sm_count=feats["sm_count"],
         max_sm_clock_hz=clock_hz, pair_seconds=pair_s,
         bound_pipe=pair["pipe"], function_pair_seconds=function_pair_s)

    phase_refusals(dev)
    parity_err = phase_parity(dev)

    base = run_state("baseline-config1", 100, dev, BATCH, ORACLE_SAMPLE, {
        "uniform": {"hash": 400, "dense": 400, "kernel": 200, "plain": 3},
        "allow-heavy": {"hash": 200, "dense": 200, "kernel": 200,
                        "plain": 0}}, pair_s, function_pair_s)
    north = run_state("north-star-10k", 10_000, dev, BATCH, ORACLE_SAMPLE, {
        "uniform": {"hash": 400, "dense": 50, "kernel": 100, "plain": 1},
        "allow-heavy": {"hash": 200, "dense": 50, "kernel": 100,
                        "plain": 0}}, pair_s, function_pair_s)

    v4_launches, state4 = phase_v4(dev)
    v6_launches = phase_v6(dev, state4)
    config2_launches = phase_config2(dev)
    l7_launches = phase_l7(dev)
    stage_launches = phase_stages(dev, state4)
    serving_launches = phase_serving(dev, state4)
    kept = []
    try:
        policy_launches = phase_policy(dev, pair_s, function_pair_s,
                                       keep=kept)
        daemon_launches = phase_daemon(dev, kept[0])
    finally:
        for run in kept:
            run.shutdown()
    kvstore_launches = phase_kvstore(dev)
    sharded_launches = phase_sharded(dev, state4)
    proxy_launches = phase_proxy(dev, state4)
    hostint_launches = phase_hostint(dev)

    def at(res):
        return {"b": res["batch"], "n": res["entries"],
                "ms": res["kernel_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"],
                "function_bound_ms": res["function_bound_ms"],
                "all_pairs_bound_ms": res["all_pairs_bound_ms"],
                "launches": res["launches"],
                "max_abs_err": res["parity"]["max_abs_err"],
                "grouping_share": res["grouping_share"]}

    runs = [res for state in (base, north) for res in state.values()]
    main_b, main_n = base["uniform"], north["uniform"]
    print(json.dumps({"kernels": [{
        "name": "dense_verdict", "route": "cuda",
        "source": "cilium_tpu_torch/csrc/dense_verdict.cu",
        "replaces": "cilium_tpu/ops/dense_verdict.py:155",
        "launches": main_b["launches"] + main_n["launches"],
        "max_abs_err": max([parity_err] + [res["parity"]["max_abs_err"]
                                           for res in runs]),
        "ms": main_b["kernel_ms"], "plain_ms": main_b["plain_ms"],
        "bound_ms": main_b["bound_ms"], "bound_by": main_b["bound_by"],
        "function_bound_ms": main_b["function_bound_ms"],
        "all_pairs_bound_ms": main_b["all_pairs_bound_ms"],
        "library_ms": None, "kernels_per_launch": list(GROUPING) +
        ["segment_verdict_kernel"],
        "shape": {"b": main_b["batch"], "n": main_b["entries"]},
        "grouping_share": main_b["grouping_share"],
        "v4_path_launches": v4_launches,
        "v6_path_launches": v6_launches,
        "config2_path_launches": config2_launches,
        "l7_path_launches": l7_launches,
        "stage_path_launches": stage_launches,
        "serving_path_launches": serving_launches,
        "policy_path_launches": policy_launches,
        "daemon_path_launches": daemon_launches,
        "kvstore_path_launches": kvstore_launches,
        "sharded_path_launches": sharded_launches,
        "proxy_path_launches": proxy_launches,
        "hostint_path_launches": hostint_launches,
        "north_star": {**at(main_n), "plain_ms": main_n["plain_ms"]},
        "allow_heavy": {"baseline": at(base["allow-heavy"]),
                        "north_star": at(north["allow-heavy"])}}]}),
          flush=True)
    print(feats["name_power_limit"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
