"""The yardstick: arithmetic, generators and draws that later changes to
the port must not move.  Each module is a frozen copy of what the port or
``bench.py`` computes, written again without importing either."""
