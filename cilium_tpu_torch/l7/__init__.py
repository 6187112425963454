"""L7 policy engines: HTTP and DNS on the device (a single request on
the host's scalar walk), Kafka on the host; the pluggable parser
framework (host) with the reference's cassandra and memcached parsers
registered; the socket proxy data plane, its xDS wire and the
supervised proxy child."""

from .http import HTTPPolicyEngine
from .kafka import KafkaPolicyEngine, KafkaRequest, parse_kafka_request
from .dns import DNSCache, DNSPolicyEngine, DNSPoller
# imported for their REGISTRY.register side effects: without these the
# production parsers are invisible to ProxyManager's parser instance
from . import cassandra as _cassandra  # noqa: F401
from . import memcached as _memcached  # noqa: F401
