"""The longest window close of the untraced stretch, each timed by the
harness from its clock tick to the return of flush_window()."""


def read(run):
    if not run.stretch_closes_ms:
        return None
    return max(run.stretch_closes_ms)
