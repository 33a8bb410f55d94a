"""The precision of the port's float32 convolutions and matmuls on the card.

PyTorch runs a float32 convolution on the card through cuDNN in TF32 by
default (``torch.backends.cudnn.allow_tf32`` is True), and a float32 matmul
in TF32 when a caller has turned ``torch.backends.cuda.matmul.allow_tf32``
on. TF32 keeps 10 mantissa bits. The reference computes true float32, so
every float32 convolution and matmul of the port runs inside
:func:`float32_precision`, which turns TF32 off for both and restores the
caller's settings afterwards, whatever they were. The one deliberate
exception is VGG-16's int8 prefix, whose float32 operands hold bf16 values
(exact in TF32); it asks for ``tf32=True`` here, so that this module is the
only place that touches the settings. (The float32 fused conv1 kernel,
``csrc/conv1_fused_f32.cu``, runs on the TF32 tensor cores by its own
means, outside these settings: it splits each operand into two TF32 parts
and takes three TF32 products, which keeps float32's accuracy; it is held
to the plain float32 version's error against float64 by
``ops/conv1_fused.py::float64_errors``.)

Which settings. PyTorch has two APIs for them: the legacy flags
(``cudnn.allow_tf32``, ``cuda.matmul.allow_tf32`` /
``torch.set_float32_matmul_precision``) and the per-operator
``fp32_precision`` values (``torch.backends.cudnn.conv.fp32_precision``,
``torch.backends.cuda.matmul.fp32_precision``). Found with
``chip_smoke.py``'s precision probe (phase 2) on an H100 with torch
2.11.0+cu128, against float64:

- the convolution and the matmul honour both APIs: TF32 gives a relative
  error of 2.6e-4, and either ``allow_tf32 = False`` or
  ``fp32_precision = 'ieee'`` gives float32's 1e-7..1e-6;
- a legacy setter writes the per-operator value too (``allow_tf32 = True``
  -> ``'tf32'``; ``cudnn.allow_tf32 = False`` -> ``'none'``, which
  inherits float32), so after it both APIs read back;
- setting a per-operator value never raises, and reading one never raises,
  but after a per-operator value is set on its own the legacy getter
  raises ``RuntimeError`` ("a mix of the legacy and new APIs"):
  ``conv.fp32_precision = 'ieee'`` makes ``cudnn.allow_tf32`` raise, and
  ``matmul.fp32_precision = 'tf32'`` makes ``matmul.allow_tf32`` and
  ``torch.get_float32_matmul_precision()`` raise. The CPU build of torch
  2.13 behaves the same.

So the scope saves, sets and restores the per-operator values, which read
back under either API: it works whichever API the caller used, and leaves
the exact values it found. Inside it the legacy getters may raise; nothing
in the port reads them.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def float32_precision(tf32: bool = False):
    """Run float32 cuDNN convolutions and cuBLAS matmuls with TF32 on or
    (by default) off; the caller's settings come back on exit. Usable as a
    decorator."""
    conv, matmul = torch.backends.cudnn.conv, torch.backends.cuda.matmul
    prev = conv.fp32_precision, matmul.fp32_precision
    conv.fp32_precision = matmul.fp32_precision = "tf32" if tf32 else "ieee"
    try:
        yield
    finally:
        conv.fp32_precision, matmul.fp32_precision = prev
