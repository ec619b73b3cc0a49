"""Adaptive protection.  Only the hysteresis primitive is ported so far
(the hot-set manager's flap damping); the controller, the degrade ladder
and the signals are ROADMAP.md Queue A item 6."""
