"""L7 policy engines: HTTP and DNS on the device, Kafka on the host;
the pluggable parser framework (host)."""
