"""moe.rows_max_over_mean: the most-loaded held expert's rows over the mean
held expert's, over every MoE block and step the run read back: E_held x
(sum of each block's largest per-expert row count) / (sum of the rows routed
to the held experts), both stacks (the program's `moe.rows_max.<stack>` and
`moe.rows.<stack>` counters). 1 is an even load; the grouped products wait
for their largest group."""

from perfbench.harness import recorder


def read(res, ctx):
    moe = ctx.config.get("moe")
    aggs = recorder.aggregates()
    rows = sum(aggs[k].count for k in aggs if k.startswith("moe.rows."))
    top = sum(aggs[k].count for k in aggs if k.startswith("moe.rows_max."))
    if moe is None or rows <= 0:
        return None
    return moe["experts_held"][1] * top / rows
