# Dense LM layers of the port (models/bridge.py carries JAX weights in).
