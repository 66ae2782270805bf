"""Median host ms a decode step spends encoding its sessions for the
commit: the program's ``serve.commit.encode`` spans (``commit_batch``'s
JSON of each session's token list) inside each ``serve.step`` span."""
from perfbench.harness import median
from perfbench.program_spans import per_outer, spans


def read(run):
    steps, enc = spans(run, "serve.step"), spans(run, "serve.commit.encode")
    if not steps or not enc:
        return None
    return median([t / 1e6 for _n, t in per_outer(steps, enc)])
