"""Operations and bytes of one launch of the port's kernels, as PERF.md's
kernel table states their bounds (rows 1, 9 and 10): bytes count each
input read once and each output written once, in f32.

  dp_round: per element, tb and acc read, theta_L and the owner's row
            written: 16 B x P x rows (one launch covers a group's rows).
  ssd_chunk_scan (forward): B H sum over chunks of Q (Q + 1) / 2 (N + P) 2
            + Q N P 2 operations; v and y (B, S, H, P), ld, g and the
            cumulative decay (B, S, H), B and C (B, S, N), the chunk states
            (B, chunks, H, N, P) and their total decays (B, chunks, H).
  ssd_chunk_scan_bwd: B H sum over chunks of Q (Q + 1) / 2 (3 N + 2 P) 2
            + 2 Q N P 2 operations; dy, v and dv (B, S, H, P), dk and dq
            (B, S, H, N), the state gradients (B, chunks, H, N, P), six
            (B, S, H) vectors (dcum, ld, g, dld, dg, the decay), B and C.
"""
from __future__ import annotations

F32 = 4


def _chunks(seq: int, chunk: int):
    return [min(chunk, seq - c) for c in range(0, seq, chunk)]


def dp_round_bytes(p: int, rows: int = 1) -> int:
    return 16 * p * rows


def ssd_fwd_ops(b: int, s: int, h: int, n: int, p: int, chunk: int) -> int:
    return b * h * sum(q * (q + 1) // 2 * (n + p) * 2 + q * n * p * 2 for q in _chunks(s, chunk))


def ssd_bwd_ops(b: int, s: int, h: int, n: int, p: int, chunk: int) -> int:
    return b * h * sum(q * (q + 1) // 2 * (3 * n + 2 * p) * 2 + 2 * q * n * p * 2
                       for q in _chunks(s, chunk))


def ssd_fwd_bytes(b: int, s: int, h: int, n: int, p: int, chunk: int) -> int:
    nc = len(_chunks(s, chunk))
    return F32 * (2 * b * s * h * p + 3 * b * s * h + 2 * b * s * n + b * nc * h * n * p
                  + b * nc * h)


def ssd_bwd_bytes(b: int, s: int, h: int, n: int, p: int, chunk: int) -> int:
    nc = len(_chunks(s, chunk))
    return F32 * (3 * b * s * h * p + 2 * b * s * h * n + b * nc * h * n * p + 6 * b * s * h
                  + 2 * b * s * n)
