#!/usr/bin/env python3
"""How far rounding alone moves a bf16 flash-attention output row, and how
far a wrong kernel moves it: the evidence for ``chip_smoke.py``'s per-row
bound (``ROW_BOUND``).

  python3 tools/flash_row_bound.py [--s 4090] [--heads 2] [--dh 128]

Runs on the CPU (~4 s, ~1 GB at the defaults). Random bf16 q, k, v from
seed 0, causal. The bf16 kernel's arithmetic is emulated: f32 scores,
unnormalised probabilities rounded to bf16 for the PV product, f32
accumulation, the f32 row sum, a bf16 output. The plain version is
``kernels.ref.flash_attention``'s (softmax in f32, normalised
probabilities rounded to bf16). For the emulated kernel, then for it
with one 64-key tile dropped for one query block, with 1 or 4 keys
masked from the later rows, and with one tile dropped from the last 90
rows, prints the worst row's rel_l2 against the plain version (each
(batch, position, head) row over the head dim), the whole tensor's
rel_l2, and the atol that rtol 2e-2 would need elementwise.
"""
from __future__ import annotations

import argparse
import math

import torch


def rows(got: torch.Tensor, want: torch.Tensor) -> str:
    d = got.float() - want.float()
    row = d.norm(dim=-1) / want.float().norm(dim=-1)
    whole = float(d.norm() / want.float().norm())
    atol = float((d.abs() - 2e-2 * want.float().abs()).max())
    return (f"worst row rel_l2 {float(row.max()):.3e}, whole rel_l2 "
            f"{whole:.3e}, atol needed at rtol 2e-2 {atol:.3e}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--s", type=int, default=4090)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--dh", type=int, default=128)
    a = ap.parse_args()
    s, h, dh = a.s, a.heads, a.dh
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, s, h, dh, generator=gen).bfloat16()
               for _ in range(3))
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(dh)
    scores = scores.masked_fill(
        ~torch.ones(s, s, dtype=torch.bool).tril(), float("-inf"))
    p = torch.softmax(scores, dim=-1)
    plain = torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(),
                         v.float()).bfloat16()

    def kernel(sc: torch.Tensor) -> torch.Tensor:
        e = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
        o = torch.einsum("bhqk,bkhd->bqhd", e.bfloat16().float(), v.float())
        return (o / e.sum(dim=-1).transpose(1, 2)[..., None]).bfloat16()

    def broken(q_rows: slice, k_rows: slice) -> torch.Tensor:
        sc = scores.clone()
        sc[:, :, q_rows, k_rows] = float("-inf")
        return kernel(sc)

    print(f"B=1 S={s} H={h} Dh={dh}, causal, bf16")
    print(f"  emulated kernel: {rows(kernel(scores), plain)}")
    mid, late = s * 3 // 4, s // 2
    cases = (("one 64-key tile dropped for one 64-query block",
              slice(mid, mid + 64), slice(s // 4, s // 4 + 64)),
             ("4 keys masked from the later half of the rows",
              slice(late, s), slice(100, 104)),
             ("1 key masked from the later half of the rows",
              slice(late, s), slice(100, 101)),
             ("one 64-key tile dropped from the last 90 rows",
              slice(s - 90, s), slice(s // 4, s // 4 + 64)))
    for name, qr, kr in cases:
        print(f"  {name}: {rows(broken(qr, kr), plain)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
