"""Training of the port: the fault-tolerant loop."""
