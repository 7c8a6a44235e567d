"""Share of its roofline that the hist kernel reaches over the traced
slice's launches (rooflines/hist.py counts the bytes and operations)."""

from harness import roofline


def read(run):
    return roofline.share("hist", run.launches.get("hist", []), run.trace,
                          run.config, run.device_name)
