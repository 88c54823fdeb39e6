"""Synthetic Criteo-format dataset generation (host side, numpy).

Counterpart of ``repro/data/synth.py``: for the same :class:`SynthConfig`
it produces the same bytes. ``encode_utf8`` is vectorised (one numpy pass
per character position instead of a Python loop per row), so the card's
smoke run can encode hundreds of thousands of rows in seconds.

  * label ∈ {0, 1}
  * dense features: mostly small non-negative ints, some negatives,
    heavy-tailed magnitudes, ~5% empty
  * sparse features: hex hashes drawn from per-column Zipf-ish pools,
    ~3% empty
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import schema as schema_lib


@dataclasses.dataclass
class SynthConfig:
    schema: schema_lib.TableSchema = schema_lib.CRITEO
    rows: int = 4096
    seed: int = 0
    # Per-column pool of distinct hash values; controls vocabulary pressure.
    sparse_pool: int = 1 << 14
    dense_scale: float = 300.0
    p_empty_dense: float = 0.05
    p_empty_sparse: float = 0.03
    p_negative: float = 0.15


def generate_binary(cfg: SynthConfig) -> dict[str, np.ndarray]:
    """Pre-decoded binary columns (the ground-truth table).

    Returns int32 arrays: label [R], dense [R, n_dense] (signed; empties are
    0), sparse [R, n_sparse] (int32 bitcast of the uint32 hash; empties 0),
    plus the bool emptiness masks.
    """
    rng = np.random.default_rng(cfg.seed)
    sch = cfg.schema
    r = cfg.rows

    label = rng.integers(0, 2, size=r, dtype=np.int32)

    mag = rng.exponential(cfg.dense_scale, size=(r, sch.n_dense))
    dense = mag.astype(np.int64)
    neg = rng.random((r, sch.n_dense)) < cfg.p_negative
    dense = np.where(neg, -dense, dense)
    dense_empty = rng.random((r, sch.n_dense)) < cfg.p_empty_dense
    dense = np.where(dense_empty, 0, dense).astype(np.int32)

    # Per-column hash pools: column c draws from pool hashes[c, :pool].
    pool = rng.integers(0, 1 << 32, size=(sch.n_sparse, cfg.sparse_pool), dtype=np.uint64)
    idx = np.minimum(
        rng.zipf(1.3, size=(r, sch.n_sparse)) - 1, cfg.sparse_pool - 1
    ).astype(np.int64)
    sparse_u32 = pool[np.arange(sch.n_sparse)[None, :], idx].astype(np.uint32)
    sparse_empty = rng.random((r, sch.n_sparse)) < cfg.p_empty_sparse
    sparse_u32 = np.where(sparse_empty, np.uint32(0), sparse_u32)
    sparse = sparse_u32.view(np.int32)

    return {
        "label": label,
        "dense": dense,
        "sparse": sparse,
        "dense_empty": dense_empty,
        "sparse_empty": sparse_empty,
    }


_DIGITS = np.frombuffer(b"0123456789abcdef", dtype=np.uint8)


def _render(values: np.ndarray, empty: np.ndarray, base: int, width: int):
    """Left-aligned text of non-negative int64 ``values`` in ``base``.

    Returns (chars uint8 [..., width], lengths int64 [...]); an empty
    field has length 0, a zero value renders as ``"0"``.
    """
    n_digits = np.ones(values.shape, np.int64)
    rest = values // base
    while np.any(rest):
        n_digits += rest > 0
        rest //= base
    chars = np.zeros(values.shape + (width,), np.uint8)
    for j in range(width):
        power = n_digits - 1 - j
        digit = (values // np.power(base, np.maximum(power, 0))) % base
        chars[..., j] = np.where(power >= 0, _DIGITS[digit], 0)
    return chars, np.where(empty, 0, n_digits)


def encode_utf8(table: dict[str, np.ndarray], cfg: SynthConfig) -> bytes:
    """Encode the binary table to the paper's UTF-8 wire format:
    ``"\\t".join(fields)`` per row, each row ending in ``"\\n"``. Dense
    values print as signed decimals, sparse values as lowercase hex
    without leading zeros, empty fields as nothing."""
    sch = cfg.schema
    rows = int(table["label"].shape[0])
    if rows == 0:
        return b"\n"
    # Decimal fields (label + dense) as sign + magnitude; hex fields unsigned.
    dec = np.concatenate(
        [table["label"].astype(np.int64)[:, None], table["dense"].astype(np.int64)],
        axis=1,
    )
    dec_empty = np.concatenate(
        [np.zeros((rows, 1), bool), table["dense_empty"]], axis=1
    )
    dec_chars, dec_len = _render(np.abs(dec), dec_empty, 10, 10)
    minus = (dec < 0) & ~dec_empty
    dec_chars = np.concatenate(
        [np.full(dec_chars.shape[:2] + (1,), schema_lib.MINUS, np.uint8), dec_chars],
        axis=2,
    )
    dec_start = np.where(minus, 0, 1)  # skip the sign slot unless negative
    dec_len = dec_len + minus
    hex_vals = table["sparse"].view(np.uint32).astype(np.int64)
    hex_chars, hex_len = _render(hex_vals, table["sparse_empty"], 16, 8)

    # Lay each field out in a fixed slot of 11 chars + 1 delimiter, then
    # keep only the used positions, in row-major order.
    slot = 12
    n_fields = sch.n_fields
    grid = np.zeros((rows, n_fields, slot), np.uint8)
    used = np.zeros((rows, n_fields, slot), bool)
    pos = np.arange(slot - 1)
    n_dec = 1 + sch.n_dense
    grid[:, :n_dec, : slot - 1] = np.take_along_axis(
        dec_chars,
        np.minimum(dec_start[..., None] + pos, slot - 2),
        axis=2,
    )
    used[:, :n_dec, : slot - 1] = pos < dec_len[..., None]
    grid[:, n_dec:, :8] = hex_chars
    used[:, n_dec:, :8] = np.arange(8) < hex_len[..., None]
    grid[:, :, slot - 1] = schema_lib.TAB
    grid[:, -1, slot - 1] = schema_lib.NEWLINE
    used[:, :, slot - 1] = True
    return grid[used].tobytes()


def pad_bytes(raw: bytes, multiple: int = 2048) -> np.ndarray:
    """Zero-pad an encoded byte string to a block multiple (uint8 array)."""
    n = len(raw)
    padded = n + (-n) % multiple
    buf = np.zeros(padded, dtype=np.uint8)
    buf[:n] = np.frombuffer(raw, dtype=np.uint8)
    return buf


def make_dataset(cfg: SynthConfig):
    """(utf8 uint8 buffer, binary table) pair for tests/benchmarks."""
    table = generate_binary(cfg)
    raw = encode_utf8(table, cfg)
    return pad_bytes(raw), table


def row_spans(buf: np.ndarray) -> np.ndarray:
    """Byte span of every encoded row: int64 ``[rows, 2]`` (start, end),
    ``end`` exclusive and including the row's trailing newline."""
    nl = np.flatnonzero(buf == schema_lib.NEWLINE)
    starts = np.concatenate([[0], nl[:-1] + 1])
    return np.stack([starts, nl + 1], axis=1)


def request_payloads(
    buf: np.ndarray, table: dict, sizes, input_format: str = "utf8"
):
    """Slice a synthetic dataset into consecutive payloads of ``sizes`` rows
    each: whole-row utf8 byte slices, or ``{label, dense, sparse}`` column
    slices (paper Config III)."""
    spans = row_spans(buf)
    row0 = 0
    for n in sizes:
        if input_format == "utf8":
            yield buf[spans[row0, 0] : spans[row0 + n - 1, 1]]
        else:
            yield {k: table[k][row0 : row0 + n] for k in ("label", "dense", "sparse")}
        row0 += n


def chunk_stream(buf: np.ndarray, chunk_bytes: int):
    """Split a padded byte buffer into row-aligned chunks, each cut at the
    last newline before the chunk boundary and zero-padded to
    ``chunk_bytes``."""
    newline_pos = np.flatnonzero(buf == schema_lib.NEWLINE)
    start = 0
    end_of_data = int(newline_pos[-1]) + 1 if newline_pos.size else 0
    while start < end_of_data:
        hard_end = min(start + chunk_bytes, end_of_data)
        # last newline in [start, hard_end)
        i = int(np.searchsorted(newline_pos, hard_end, side="left")) - 1
        if i < 0 or newline_pos[i] < start:
            raise ValueError(
                f"row longer than chunk_bytes={chunk_bytes}; raise chunk size"
            )
        end = int(newline_pos[i]) + 1
        chunk = np.zeros(chunk_bytes, dtype=np.uint8)
        chunk[: end - start] = buf[start:end]
        yield chunk
        start = end
