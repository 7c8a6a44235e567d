"""Share of its roofline that the fused_news kernel reaches over the
traced slice's launches in the flood cell, where news planes carry ~90%
of the records (rooflines/fused_news_flood.py counts as fused_news)."""

from harness import roofline


def read(run):
    return roofline.share("fused_news_flood",
                          run.launches.get("fused_news_flood", []),
                          run.trace, run.config, run.device_name)
