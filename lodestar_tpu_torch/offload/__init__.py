"""The offload layer of the port: so far only the circuit breaker."""
