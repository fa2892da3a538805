"""Encoder profiles: named configurations of backend + numerics.

The reference has exactly one hard-coded quality/speed point
(encoder.c:95,:517-519).  Profiles keep that point as CONFORMANCE while
exposing the JAX device pipeline as FAST."""

from .profiles import Profile, CONFORMANCE, FAST, get_profile

__all__ = ["Profile", "CONFORMANCE", "FAST", "get_profile"]
