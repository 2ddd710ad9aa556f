"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version (``ref``) and reached through ``ops``:

* flash_attention — online-softmax prefill attention (CUDA C++,
  ``csrc/flash_attention.cu``), replacing the Pallas
  ``repro/kernels/flash_attention.py::flash_attention_kernel``.

The reference's other Pallas kernels (ring_pack, rwkv6_scan, rglru) are
listed in ROADMAP.md, Queue 2.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
