"""The atomic serving cell: ``hymba.decode``'s model, weights, traffic and
reference (``entries/serve.py``'s functions, loaded by path) with every
decode step committed as one cross-shard mini-transaction
(``ServeConfig.atomic_step_commit``: ``CurpSessionStore.txn`` of the
step's sessions, all or none after a crash), in the serving window of
``entries/serve_granite.py``.  A traced run times ``store.txn`` as the
step's commit (``serve.commit_ms.atomic``).
"""
from __future__ import annotations

from pathlib import Path

from perfbench import counts, harness

_here = Path(__file__).parent
_serve = harness.load_module(_here / "serve.py")
_window = harness.load_module(_here / "serve_granite.py")


def run(run) -> None:
    _window.serve(run, make_weights=_serve.make_weights,
                  check_gaps=_serve.check_gaps,
                  step_bytes=lambda m, ctx, _touched:
                  counts.decode_bytes(m, ctx),
                  step_flops=counts.decode_flops, atomic=True)
