"""Share of its roofline that the fused_news kernel reaches over the traced
slice's launches (rooflines/fused_news.py counts the bytes and operations)."""

from harness import roofline


def read(run):
    return roofline.share("fused_news", run.launches.get("fused_news", []), run.trace,
                          run.config, run.device_name)
