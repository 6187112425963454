"""L7 policy engines: HTTP and DNS on the device, Kafka on the host;
the pluggable parser framework (host) with the reference's cassandra
and memcached parsers registered."""

# imported for their REGISTRY.register side effects: without these the
# production parsers are invisible to ProxyManager's parser instance
from . import cassandra as _cassandra  # noqa: F401
from . import memcached as _memcached  # noqa: F401
