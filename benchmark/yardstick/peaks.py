"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W).

Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``OPS_PER_S``) and kept
here unchanged so that a change to the program cannot move the yardstick:
bytes over the HBM rate; operations over the float32 rate outside the
tensor cores, 67 TFLOP/s counting a fused multiply-add as two, so 33.5e12
operations a second, integer and compare operations counted at the same
rate (a floor).
"""

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 33.5e12
