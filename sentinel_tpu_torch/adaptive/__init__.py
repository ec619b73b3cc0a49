"""Adaptive protection.  Ported so far: the hysteresis primitive (the
client's cluster degrade, the hot-set manager's flap damping) and the
reconnect backoff (the cluster token client); the controller, the degrade
ladder and the signals are ROADMAP.md Queue A item 6."""
