"""Share of its roofline that the fused_lane kernel reaches over the traced
slice's launches (rooflines/fused_lane.py counts the bytes and operations)."""

from harness import roofline


def read(run):
    return roofline.share("fused_lane", run.launches.get("fused_lane", []), run.trace,
                          run.config, run.device_name)
