# Dense LM layers and the Table IV CNN of the port (models/bridge.py carries
# JAX weights in).
