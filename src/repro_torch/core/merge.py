"""The CRDT-CURP merge lattice: per-op-type commutativity widening.

CURP's fast path (paper §2, §3.2.2) treats ANY two concurrent writes of the
same key as conflicting.  That is the right call for SET — last-writer-wins
makes order observable — but it is strictly conservative for typed ops that
commute *by construction* (Shapiro's CRDTs, Kuznetsov's wait-free RDTs in
PAPERS.md): two INCRs produce the same counter in either order, two SADDs
the same set, two bounded-MAXes the same maximum, and two HMSETs over
DISJOINT fields the same hash.  This module is the single source of truth
for that widened commutativity relation, consulted by every mirrored layer:

- ``Witness.record`` / ``commutes_with_all`` (core/witness.py),
- the device witness gang + fused fast-path CUDA kernels
  (repro_torch/kernels/ops.py, kernels/csrc/) — the kernels take
  ``CONFLICT_MATRIX`` as a 16-entry row table and consult it in-launch,
- the master's unsynced-window check (core/master.py) and witness-replay
  recovery merge-fold.

Encoding
--------
Every op expands to ``(key_hash, op_class)`` pairs via ``op_hash_classes``;
the pair list is what witnesses record and masters refcount.  Classes:

====  =======  ==========================================================
cls   op       merge rule
====  =======  ==========================================================
0     SET      conflicts with everything (incl. itself): order observable
1     DEL      conflicts with everything
2     INCR     INCR || INCR merges (addition commutes)
3     HMSET    HMSET || HMSET merges at the BASE hash; field overlap is
               caught by the per-field FIELD sub-hash pairs
4     FIELD    derived per-field sub-key of an HMSET; FIELD || FIELD
               conflicts, so two HMSETs overlap iff they share a field
5     SADD     set-add commutes (union)
6     APPEND   commutes under the canonical sorted-chunks value
7     MAX      max commutes and is idempotent
8     OTHER    conservative catch-all (reads, TXN legs, migration ops)
====  =======  ==========================================================

``CONFLICT_MATRIX[a]`` is a 16-bit row: bit ``b`` set iff class ``a``
conflicts with class ``b``.  The matrix is built FROM ``MERGEABLE`` —
conflict(a, b) = NOT (a == b AND a in MERGEABLE) — so the Python
predicate, the packed rows, and the kernels' in-dispatch consults cannot
drift apart (tests assert all three agree over all 16x16 pairs).

Class 0 is deliberately SET: the device tables pack a slot's class into
the occupancy plane as ``occ = 0 (empty) | 1 + class``, so every
pre-lattice all-SET workload keeps its exact occ values (occ == 1) and the
historical kernels' bit-exactness tests hold unchanged.
"""
from __future__ import annotations

from typing import List, Tuple

# --- op classes -------------------------------------------------------------
CLS_SET = 0
CLS_DEL = 1
CLS_INCR = 2
CLS_HMSET = 3
CLS_FIELD = 4
CLS_SADD = 5
CLS_APPEND = 6
CLS_MAX = 7
CLS_OTHER = 8
N_CLASSES = 16          # matrix rows; headroom for future classes

#: Classes whose ops merge with a concurrent op of the SAME class.
MERGEABLE = frozenset({CLS_INCR, CLS_HMSET, CLS_SADD, CLS_APPEND, CLS_MAX})

#: Bit c set iff class c is mergeable — the kernels' scalar shortcut.
MERGE_MASK = 0
for _c in MERGEABLE:
    MERGE_MASK |= 1 << _c

#: CONFLICT_MATRIX[a] bit b == 1 iff class a conflicts with class b.
#: Built from MERGEABLE: only the diagonal of a mergeable class clears.
CONFLICT_MATRIX: Tuple[int, ...] = tuple(
    (0xFFFF & ~(1 << a)) if a in MERGEABLE else 0xFFFF
    for a in range(N_CLASSES)
)


def conflicts(a: int, b: int) -> bool:
    """True iff concurrent ops of classes ``a`` and ``b`` on the same key
    hash must take the slow path (the §2 commutativity test, widened)."""
    return bool((CONFLICT_MATRIX[a] >> b) & 1)


def field_subkey(key, field) -> str:
    """Derived sub-key naming one HMSET field of ``key``.  Two HMSETs of
    the same key share a FIELD pair iff they share a field name, which is
    exactly the §2 overlap that makes them non-commutative."""
    return f"{key!r}\x1fhf\x1f{field!r}"


def op_hash_classes(op) -> List[Tuple[int, int]]:
    """Expand an op into the ``(key_hash, op_class)`` pairs the lattice
    reasons over.  Single source of truth — ``Op.hash_classes()`` memoizes
    this, and every witness/master/kernel layer consumes those pairs."""
    from .types import OpType, keyhash

    t = op.op_type
    if t == OpType.SET:
        return [(keyhash(k), CLS_SET) for k in op.keys]
    if t == OpType.DEL:
        return [(keyhash(k), CLS_DEL) for k in op.keys]
    if t == OpType.INCR:
        return [(keyhash(k), CLS_INCR) for k in op.keys]
    if t == OpType.SADD:
        return [(keyhash(k), CLS_SADD) for k in op.keys]
    if t == OpType.APPEND:
        return [(keyhash(k), CLS_APPEND) for k in op.keys]
    if t == OpType.MAX:
        return [(keyhash(k), CLS_MAX) for k in op.keys]
    if t == OpType.MSET:
        return [(keyhash(k), CLS_SET) for k in op.keys]
    if t == OpType.HMSET:
        k = op.keys[0]
        fields = op.args[0] if op.args else ()
        pairs = [(keyhash(k), CLS_HMSET)]
        pairs.extend(
            (keyhash(field_subkey(k, f)), CLS_FIELD) for f, _v in fields
        )
        return pairs
    # Reads, NOOP, TXN legs, migration ops: conservative — OTHER conflicts
    # with every class, reproducing the un-widened CURP check exactly.
    return [(keyhash(k), CLS_OTHER) for k in op.keys]


__all__ = [
    "CLS_SET", "CLS_DEL", "CLS_INCR", "CLS_HMSET", "CLS_FIELD",
    "CLS_SADD", "CLS_APPEND", "CLS_MAX", "CLS_OTHER", "N_CLASSES",
    "MERGEABLE", "MERGE_MASK", "CONFLICT_MATRIX",
    "conflicts", "field_subkey", "op_hash_classes",
]
