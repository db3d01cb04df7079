"""queue.gc_pause_pct: the seconds of Python's collections while a serving
queue was open (`queue.gc_pause.<generation>`), over the seconds the queues
were open (`queue.open`), in % (the program's recorder)."""

from perfbench.harness import recorder


def read(res, ctx):
    aggs = recorder.aggregates()
    opened = aggs.get("queue.open")
    if opened is None or not opened.total:
        return None
    paused = sum(a.total for name, a in aggs.items() if name.startswith("queue.gc_pause."))
    return 100.0 * paused / opened.total
