"""Output tokens of the requests completed in the window, over the time
from the window's start to the last of those completions."""


def read(rec):
    done = [r for r in rec["handed"]
            if r.done is not None and r.done <= rec["t_end"]]
    if not done:
        return None
    return sum(r.max_new for r in done) / (max(r.done for r in done)
                                           - rec["t0"])
