"""The pack and unpack kernels' share of their roofline: the bytes they
must move for the flat f32 gradient (``flops.ring_pack_bytes``: each
byte read once and written once) at the card's memory bandwidth, over
their device time per profiled step."""
from portbench import flops
from portbench.readers import is_ring_pack, per_step_ms


def read(rec):
    ms = per_step_ms(rec, is_ring_pack)
    if not ms:
        return None
    nbytes = flops.ring_pack_bytes(flops.param_count(rec["cfg"]),
                                   rec["mix"]["comm"]["compress"])
    return 100.0 * nbytes / flops.PEAK_HBM_BYTES_S / (ms / 1e3)
