"""Device (JAX) and host (numpy) compute stages for the VarDCT
pipeline: color transform, DCT, quantization, context modeling,
tokenization, histograms."""
