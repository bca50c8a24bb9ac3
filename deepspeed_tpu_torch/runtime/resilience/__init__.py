"""Resilience for the serving fleet: the chaos seams (``chaos``) its
failover and migration contracts are proved with."""
