"""HBM bytes that one exact-line-search PGD step needs, whatever implements it.

A step makes two products, A d and A^T r.  Each reads A's values and its
int32 indices once (``nnz`` of each) and its (S, n) or (S, m) operand once,
and writes its (S, m) or (S, n) result once.  This equals reading the
step's state (x and r) once and writing it once, plus A twice.  Shapes are
the instance's own (n columns, not the program's padded layout), float32.
"""


def step_bytes(shapes: dict) -> int:
    S, n, m, nnz = shapes["S"], shapes["n"], shapes["m"], shapes["nnz"]
    a_bytes = nnz * (4 + 4)
    return 2 * a_bytes + 2 * 4 * S * (n + m)
