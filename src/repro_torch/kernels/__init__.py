"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version (``ref``) and reached through ``ops``:

* flash_attention — online-softmax prefill attention (CUDA C++,
  ``csrc/flash_attention.cu``: bf16 on the tensor cores with ``wgmma``
  and TMA loads, f32 on an exact FMA kernel; GQA/MQA K/V read at their
  KV heads), replacing the Pallas
  ``repro/kernels/flash_attention.py::flash_attention_kernel``.
* pack_slices / unpack_slices — the ring-buffer pack (add error
  feedback, cast to the wire, capture the residual) and unpack (cast
  back) passes of the gradient exchange (CUDA C++, ``csrc/ring_pack.cu``),
  replacing the Pallas ``repro/kernels/ring_pack.py::pack_slices_kernel``
  and ``unpack_slices_kernel``.
* wkv6 — the RWKV-6 time-mix recurrence (CUDA C++,
  ``csrc/rwkv6_scan.cu``), replacing the Pallas
  ``repro/kernels/rwkv6_scan.py::wkv6_kernel``.
* rglru — the RG-LRU linear recurrence (CUDA C++, ``csrc/rglru.cu``),
  replacing the Pallas ``repro/kernels/rglru.py::rglru_kernel``.

Every Pallas kernel of the reference now has its counterpart here.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
