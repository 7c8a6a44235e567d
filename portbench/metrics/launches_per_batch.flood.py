"""`launches_per_batch.l4`'s reading in the flood cell: kernels the traced
slice launched (window closes included) per batch, on the news-heavy
group signatures a flood makes."""


def read(run):
    return run.launches_per_batch()
