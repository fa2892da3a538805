"""hydrium-tpu: a JPEG XL (VarDCT, streaming) encoder whose math runs as a
JAX device pipeline on a GPU.

A from-scratch reimplementation of the capabilities of Traneptora/hydrium
(the reference), batched for an accelerator:

- Device plane (JAX, plain jax.numpy / lax compiled by XLA): batched
  per-group stages -- RGB->XYB color transform, 8x8 forward DCT as two
  float32 matmuls, LF/HF quantization, context modeling and hybrid-uint
  tokenization, per-cluster histograms, packed transfer streams.
- Host serialization plane (C++ / Python): bit-exact JPEG XL codestream
  assembly -- bit writer, prefix coding, rANS with alias tables, section/TOC
  layout.  Serial per stream, parallel across groups.
- Orchestration plane (Python): `Encoder` preserving hydrium's streaming
  API contract (send_tile / provide_output_buffer / flush), CLI, sharding.

Reference parity documented per-module with hydrium file:line citations.
"""

from .version import __version__
from .config import ImageMetadata, SampleFormat, HYD_UINT8, HYD_UINT16, HYD_FLOAT32
from .encoder import (BufferedEncoder, Encoder, NEED_MORE_OUTPUT, OK,
                      encode_image)

__all__ = [
    "__version__",
    "ImageMetadata",
    "SampleFormat",
    "HYD_UINT8",
    "HYD_UINT16",
    "HYD_FLOAT32",
    "Encoder",
    "BufferedEncoder",
    "OK",
    "NEED_MORE_OUTPUT",
    "encode_image",
]
