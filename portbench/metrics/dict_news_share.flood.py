"""Share of the records put in the untraced stretch that the dict packer
sent on news planes (`l4_dict_news_rows` over `rows_in`): a flow's first
record in the dict, or its first since the LRU evicted it. Under a flood
it shows how far the one-shot keys flush the pool's flows out of the
dict. None from a program without the counter."""


def read(run):
    c0, c1 = run.stretch_counters
    if "l4_dict_news_rows" not in c1:
        return None
    rows = c1["rows_in"] - c0["rows_in"]
    if rows <= 0:
        return None
    return 100.0 * (c1["l4_dict_news_rows"]
                    - c0.get("l4_dict_news_rows", 0)) / rows
