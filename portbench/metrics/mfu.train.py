"""The training step's share of the card's bf16 peak: the FLOPs a step
needs (``flops.train_step_flops``) times the steps, over the window."""
from portbench import flops


def read(rec):
    mix = rec["mix"]
    work = flops.train_step_flops(rec["cfg"], mix["global_batch"],
                                  mix["seq_len"]) * rec["steps"]
    return 100.0 * work / (rec["t_end"] - rec["t0"]) / flops.PEAK_BF16_FLOPS
