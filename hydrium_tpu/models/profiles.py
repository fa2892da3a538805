"""Named encoder profiles."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Profile:
    """An encoder configuration point, passed to Encoder(profile=...).

    backend: math plane ("numpy" = bit-exact with the reference's
    fixed-point/LUT arithmetic; "jax" = the JAX device pipeline with
    direct float math, equal-or-better PSNR).
    """

    name: str
    backend: str


#: Byte-identical to the reference encoder for identical inputs.
CONFORMANCE = Profile(name="conformance", backend="numpy")

#: The JAX device pipeline (the production path).
FAST = Profile(name="fast", backend="jax")

_PROFILES = {p.name: p for p in (CONFORMANCE, FAST)}


def get_profile(name: str) -> Profile:
    try:
        return _PROFILES[name]
    except KeyError:
        raise ValueError(
            f"unknown profile {name!r}; available: {sorted(_PROFILES)}")
