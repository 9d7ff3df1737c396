"""Roofline efficiency ledger: analytic FLOPs/bytes cost model, device
peak table and MFU/MBU attribution (port of ``observability/roofline.py``).

It turns rates into utilizations, the fraction of the card a phase
achieves, and classifies each phase and each recorded program compute-
or bandwidth-bound on the roofline model (arithmetic intensity against
the ridge point peak_flops / peak_bandwidth).

Three parts, as in the JAX module:

  GPTCostModel   — analytic FLOPs/bytes for the GPT family from its config
                   alone: per-token train FLOPs (forward and backward),
                   per-token decode FLOPs at a context, prefill FLOPs per
                   chunk (chunk sums telescope to the whole prompt's
                   figure), and the bytes a decode step must read (the
                   weights once per batched step and each slot's context
                   KV under the monolithic, paged or int8 layout).
  DevicePeaks    — peak FLOP/s per dtype and HBM bytes/s, keyed on a
                   substring of the device name.  An unknown name returns
                   None and every MFU/MBU downstream reports None: a peak
                   is never invented.
  Roofline       — what the trainer, the batcher and the run report carry
                   under ``--roofline``: the peaks, the device count, the
                   compute dtype and the cost model, with ``mfu()`` and
                   ``mbu()``.

The peak table is the card's: the NVIDIA H100 SXM's data-sheet figures,
matched as a substring of ``torch.cuda.get_device_name()`` (``NVIDIA
H100 80GB HBM3``).  Dense tensor-core rates for bf16 and fp16 (one "bf16"
key, as in the JAX table) and int8; f32 at the CUDA cores' rate, not the
TPU MXU's "half of bf16" rule, because the harness turns TF32 off, so an
f32 GEMM runs on the CUDA cores.  The H100's other variants (PCIe, NVL)
have other peaks and return None until their own figures are entered;
so do a TPU's name, ``cpu`` and None.  ``chip_smoke.py`` takes its
kernels' bound constants from this table.

Accounting rules (as in the JAX module):

* MFU uses *model* FLOPs — the matmul FLOPs the math requires (2·MACs,
  backward = 2× forward).  Rematerialization, elementwise work and the
  optimizer are never credited; a measured FLOP count (the program
  ledger's ``flops``) rides beside it as a cross-check only.
* MBU counts the bytes the model *must* read — the weights once per
  batched decode step and the written KV context per slot (block-
  granular under the paged layout, payload and scales under int8) —
  never the bytes a kernel happened to move.
* Every published MFU/MBU states ``PEAK_TABLE_REVISION``: a revision
  bump re-bases every claim.

Stdlib only: the analyze CLI renders roofline tables offline from a run
report or manifest without importing torch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

# Revision of the peak figures below.  Bump when any entry changes and
# state the revision with every published MFU/MBU claim.
PEAK_TABLE_REVISION = "h100-1"

# Data-sheet figures per device name substring: (substring, {dtype key:
# dense FLOP/s}, HBM bytes/s).  First match wins.  The H100 SXM: 989.4
# TFLOP/s dense bf16/fp16 and 1979 TOPS int8 on the tensor cores, 67
# TFLOP/s f32 on the CUDA cores, 3.35 TB/s HBM3.
_DEVICE_PEAKS = (
    ("h100 80gb hbm3", {"bf16": 989e12, "f32": 67e12, "int8": 1979e12},
     3.35e12),
)

_KV_SCALE_BYTES = 4  # int8 KV: one f32 max-abs scale per (position, kv_head)


@dataclass(frozen=True)
class DevicePeaks:
    """Peak figures for one device kind, at PEAK_TABLE_REVISION."""

    device_kind: str
    flops_per_s: dict          # dtype key ("bf16"/"f32"/"int8") -> flops/s
    hbm_bytes_per_s: float
    revision: str = PEAK_TABLE_REVISION


def device_peaks(device_kind: str | None) -> DevicePeaks | None:
    """Peak table lookup.  Unknown/None names return None — downstream
    MFU/MBU then report None rather than a number against a fabricated
    peak."""
    if not device_kind:
        return None
    kind = str(device_kind).lower()
    for sub, flops, hbm in _DEVICE_PEAKS:
        if sub in kind:
            return DevicePeaks(str(device_kind), dict(flops), hbm)
    return None


def _dtype_key(dtype) -> str:
    s = str(dtype)
    if "bfloat16" in s or "float16" in s:
        return "bf16"
    if "int8" in s:
        return "int8"
    return "f32"


def _kv_itemsize(kv_dtype) -> int:
    s = str(kv_dtype)
    if "int8" in s:
        return 1
    if "bfloat16" in s or "float16" in s:
        return 2
    return 4


@dataclass
class GPTCostModel:
    """Analytic FLOPs/bytes for one GPT config (models/gpt.py fields).

    FLOPs are matmul FLOPs only (2·MACs): embeddings are gathers, LN and
    softmax are elementwise — excluded, the standard MFU accounting the
    CNN bench already uses.  MoE counts the ACTIVE path (top-1 through
    one ffn-wide expert — identical FLOPs to dense by construction,
    models/moe.py) plus the router projection.
    """

    vocab: int
    hidden: int
    layers: int
    heads: int
    ffn: int
    max_len: int
    kv_heads: int | None = None
    causal: bool = True
    learned_pos: bool = True
    tie_embeddings: bool = True
    moe_experts: int = 0
    kv_dtype: str = "f32"          # KV cache storage: "f32"|"bf16"|"int8"
    kv_layout: str = "monolithic"  # "monolithic"|"paged"
    paged_block: int = 16
    # measured stored-param bytes (sum of actual leaf nbytes) when the
    # caller has real params in hand; the analytic 4-byte-f32 weight
    # count is the fallback
    param_bytes_override: int | None = None

    @classmethod
    def from_model(cls, model, **overrides) -> "GPTCostModel | None":
        """Duck-typed construction from a GPT-family module (any object
        with the ``models/gpt.py`` config fields).  Returns None for
        models the analytic family doesn't cover (no ``causal_lm``
        marker) — callers then report MFU as None, never a wrong one."""
        if not getattr(model, "causal_lm", False):
            return None
        kw = dict(
            vocab=int(model.vocab_size),
            hidden=int(model.hidden),
            layers=int(model.layers),
            heads=int(model.heads),
            ffn=int(model.ffn),
            max_len=int(model.max_len),
            kv_heads=getattr(model, "kv_heads", None),
            learned_pos=getattr(model, "positional", "learned") == "learned",
            tie_embeddings=bool(getattr(model, "tie_embeddings", True)),
            moe_experts=int(getattr(model, "moe_experts", 0) or 0),
        )
        kw.update(overrides)
        return cls(**kw)

    # -- shapes -----------------------------------------------------------

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def n_kv_heads(self) -> int:
        return int(self.kv_heads) if self.kv_heads else self.heads

    @property
    def kv_hidden(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self, active_only: bool = True) -> int:
        """Matmul weight count (biases/LN excluded — sub-percent).  With
        ``active_only`` (the decode must-read figure) MoE counts one
        expert's MLP; otherwise all experts are counted (storage)."""
        n = self.vocab * self.hidden
        if self.learned_pos:
            n += self.max_len * self.hidden
        attn = self.hidden * (self.hidden + 2 * self.kv_hidden) \
            + self.hidden * self.hidden
        mlp = 2 * self.hidden * self.ffn
        e = self.moe_experts
        per_layer = attn + (mlp if (active_only or not e) else e * mlp)
        if e:
            per_layer += self.hidden * e  # router projection
        n += self.layers * per_layer
        if not self.tie_embeddings:
            n += self.hidden * self.vocab
        return n

    def param_bytes(self) -> int:
        """Stored-param bytes a decode step must stream (active path).
        Measured leaf bytes when the caller provided them; 4-byte
        weights otherwise."""
        if self.param_bytes_override is not None:
            return int(self.param_bytes_override)
        return 4 * self.param_count(active_only=True)

    # -- FLOPs ------------------------------------------------------------

    @property
    def _proj_flops_per_token(self) -> float:
        """Per-token projection/MLP matmul FLOPs, all layers: QKV
        (GQA-aware) + attention output + MLP up/down (or the active MoE
        expert + router)."""
        per_layer = (2.0 * self.hidden * (self.hidden + 2 * self.kv_hidden)
                     + 2.0 * self.hidden * self.hidden
                     + 4.0 * self.hidden * self.ffn)
        if self.moe_experts:
            per_layer += 2.0 * self.hidden * self.moe_experts  # router
        return self.layers * per_layer

    @property
    def lm_head_flops(self) -> float:
        """Logit projection for ONE position (2·h·V)."""
        return 2.0 * self.hidden * self.vocab

    def fwd_flops_per_token(self, seq_len: int) -> float:
        """Forward matmul FLOPs per token of a full-sequence (training)
        pass at ``seq_len``: projections + the QK^T/PV einsums (4·S·h,
        halved causal — the average position attends S/2 keys) + the
        per-position LM head."""
        attn = 4.0 * seq_len * self.hidden * (0.5 if self.causal else 1.0)
        return (self._proj_flops_per_token + self.layers * attn
                + self.lm_head_flops)

    def train_flops_per_token(self, seq_len: int) -> float:
        """Fwd+bwd per token: backward costs ~2× forward (grads wrt both
        activations and weights) — the standard ×3 MFU accounting.
        Rematerialization is NEVER credited: remat recompute
        is overhead MFU must expose, not model work."""
        return 3.0 * self.fwd_flops_per_token(seq_len)

    def train_step_flops(self, batch: int, seq_len: int,
                         grad_accum: int = 1) -> float:
        """Model FLOPs of one optimizer step over ``batch`` sequences.
        Independent of ``grad_accum`` — K microbatches of batch/K sum to
        the same token count; the argument exists so the invariant is
        explicit (and pinned in tests)."""
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        return batch * seq_len * self.train_flops_per_token(seq_len)

    def decode_flops_per_token(self, context: int) -> float:
        """One new token with a KV cache holding ``context`` attended
        keys: projections + 4·L·h attention (no causal halving — the
        single query row attends everything) + the LM head."""
        return (self._proj_flops_per_token
                + self.layers * 4.0 * context * self.hidden
                + self.lm_head_flops)

    def verify_flops(self, context: int, width: int) -> float:
        """Speculative verify of ``width`` positions (k_eff+1 — the k
        drafted tokens plus the bonus position) in ONE batched step:
        position j attends context+j keys.  Weights are read once — the
        bytes side does not scale with width (see decode_step_bytes)."""
        return sum(self.decode_flops_per_token(context + j)
                   for j in range(int(width)))

    def prefill_chunk_flops(self, n: int, start: int = 0) -> float:
        """A prefill chunk of ``n`` prompt tokens beginning at absolute
        position ``start``: token at position p attends p+1 keys, so the
        attention term telescopes — chunk sums equal the monolithic
        figure exactly.  The LM head is EXCLUDED (serving computes logits
        for the last prompt position only — add ``lm_head_flops`` once
        per completed prefill)."""
        n = int(n)
        if n <= 0:
            return 0.0
        attn = 4.0 * self.hidden * (n * start + n * (n + 1) / 2.0)
        return n * self._proj_flops_per_token + self.layers * attn

    # -- bytes ------------------------------------------------------------

    @property
    def _kv_bytes_per_position(self) -> int:
        """KV bytes WRITTEN per cached position, all layers: K and V
        vectors (kv_hidden each) at the storage dtype, plus the f32
        max-abs scale per (position, kv_head) vector under int8."""
        per_layer = 2 * self.kv_hidden * _kv_itemsize(self.kv_dtype)
        if _kv_itemsize(self.kv_dtype) == 1:
            per_layer += 2 * self.n_kv_heads * _KV_SCALE_BYTES
        return self.layers * per_layer

    def kv_read_bytes(self, length: int) -> int:
        """Bytes a decode step MUST read for one slot with ``length``
        cached positions.  Paged layout reads block-granular —
        ceil(L/block)·block positions; monolithic credits exactly L even
        though the compiled program scans the whole max_len table (those
        idle bytes are the inefficiency MBU exposes)."""
        length = int(length)
        if length <= 0:
            return 0
        if self.kv_layout == "paged":
            length = math.ceil(length / self.paged_block) * self.paged_block
        return length * self._kv_bytes_per_position

    def decode_step_bytes(self, contexts) -> int:
        """Must-read bytes of ONE batched decode (or speculative verify)
        step over live slots with the given context lengths: the active
        weights once — every slot shares the stream — plus each slot's
        written KV context."""
        return self.param_bytes() + sum(
            self.kv_read_bytes(c) for c in contexts)


# ---------------------------------------------------------------------------
# attribution helpers (stdlib — analyze renders these offline)
# ---------------------------------------------------------------------------

def arithmetic_intensity(flops, bytes_accessed) -> float | None:
    """FLOPs per byte, None when either side is unknown/zero (CPU
    backends may report neither)."""
    if not flops or not bytes_accessed:
        return None
    return float(flops) / float(bytes_accessed)


def ridge_point(peaks: DevicePeaks | None, dtype: str = "bf16"):
    """Intensity (flops/byte) above which the device is compute-bound."""
    if peaks is None:
        return None
    peak = peaks.flops_per_s.get(dtype)
    if not peak or not peaks.hbm_bytes_per_s:
        return None
    return peak / peaks.hbm_bytes_per_s


def classify_bound(intensity, peaks: DevicePeaks | None,
                   dtype: str = "bf16") -> str | None:
    """'compute' or 'bandwidth', None when the intensity or the device
    peaks are unknown."""
    ridge = ridge_point(peaks, dtype)
    if intensity is None or ridge is None:
        return None
    return "compute" if intensity >= ridge else "bandwidth"


def attainable_fraction(intensity, peaks: DevicePeaks | None,
                        dtype: str = "bf16") -> float | None:
    """Roofline ceiling as a fraction of peak FLOPs: min(1, I·BW/peak).
    The best ANY schedule of this program could achieve — rendered by
    ``analyze roofline`` as %-of-peak."""
    ridge = ridge_point(peaks, dtype)
    if intensity is None or ridge is None:
        return None
    return min(1.0, intensity / ridge)


def program_attribution(programs: dict, peaks: DevicePeaks | None = None,
                        dtype: str = "bf16") -> list:
    """Per-program roofline rows from a ProgramLedger manifest's
    ``programs`` table (flops/bytes_accessed columns): name, flops,
    bytes, intensity, bound, attainable %-of-peak.  None-tolerant
    throughout — a manifest with no measured FLOPs or bytes yields rows
    of Nones, not a crash."""
    rows = []
    for name in sorted(programs):
        rec = programs[name] or {}
        flops = rec.get("flops")
        nbytes = rec.get("bytes_accessed")
        intensity = arithmetic_intensity(flops, nbytes)
        rows.append({
            "program": name,
            "flops": flops,
            "bytes_accessed": nbytes,
            "arithmetic_intensity": (round(intensity, 3)
                                     if intensity is not None else None),
            "bound": classify_bound(intensity, peaks, dtype),
            "attainable_frac_of_peak": (
                round(attainable_fraction(intensity, peaks, dtype), 4)
                if attainable_fraction(intensity, peaks, dtype) is not None
                else None),
        })
    return rows


def flops_crosscheck(analytic, xla) -> float | None:
    """Measured / analytic FLOPs ratio (the sanity cross-check: a
    measured count includes elementwise/optimizer work the model count
    excludes, so healthy ratios sit modestly above 1)."""
    if not analytic or not xla:
        return None
    return float(xla) / float(analytic)


# ---------------------------------------------------------------------------
# the wiring object
# ---------------------------------------------------------------------------

class Roofline:
    """What ``--roofline`` threads through the trainer, the batcher, the
    fleet and the run report: device peaks (None = honest unknown), the
    device count MFU/MBU normalize over, the compute dtype, and the
    analytic cost model (None for model families the analytic accounting
    doesn't cover — utilizations are then None, never invented)."""

    def __init__(self, peaks: DevicePeaks | None, n_devices: int = 1,
                 cost: GPTCostModel | None = None, dtype: str = "bf16"):
        self.peaks = peaks
        self.n_devices = max(int(n_devices), 1)
        self.cost = cost
        self.dtype = dtype
        self.revision = PEAK_TABLE_REVISION

    @classmethod
    def for_device(cls, device_kind, n_devices: int = 1,
                   cost: GPTCostModel | None = None,
                   dtype: str = "bf16") -> "Roofline":
        return cls(device_peaks(device_kind), n_devices, cost, dtype)

    @classmethod
    def for_model(cls, model, device_kind, n_devices: int = 1,
                  **cost_overrides) -> "Roofline":
        """Training-side construction: cost model from the module's
        config (None for non-GPT models), compute dtype from its dtype."""
        cost = GPTCostModel.from_model(model, **cost_overrides)
        return cls(device_peaks(device_kind), n_devices, cost,
                   _dtype_key(getattr(model, "dtype", "float32")))

    @classmethod
    def for_kv(cls, kv, device_kind, n_devices: int = 1) -> "Roofline":
        """Serving-side construction from a slot KV table: the decode
        model's config plus the table's ACTUAL storage dtype/layout, and
        measured stored-param bytes when the table exposes them.  The
        port's tables hold their decode model as ``model`` (JAX's
        ``dm``)."""
        model = getattr(kv, "model", None)
        cost = GPTCostModel.from_model(
            model,
            kv_dtype=str(getattr(kv, "kv_dtype", None)
                         or getattr(model, "dtype", "float32")),
            kv_layout=str(getattr(kv, "kv_layout", "monolithic")
                          or "monolithic"),
            paged_block=int(getattr(kv, "paged_block", None)
                            or getattr(model, "paged_block", 16) or 16),
        ) if model is not None else None
        if cost is not None:
            measured = getattr(kv, "param_leaf_bytes", None)
            if callable(measured):
                try:
                    cost.param_bytes_override = int(measured())
                except Exception:  # noqa: BLE001 — analytic fallback
                    pass
        dtype = _dtype_key(getattr(model, "dtype", "float32"))
        return cls(device_peaks(device_kind), n_devices, cost, dtype)

    # -- utilizations -----------------------------------------------------

    def flops_peak(self) -> float | None:
        if self.peaks is None:
            return None
        return self.peaks.flops_per_s.get(self.dtype)

    def mfu(self, achieved_flops_per_s) -> float | None:
        """achieved model flops/s over the FLEET's peak (n_devices × per-
        chip peak).  None when the device or the achieved side is
        unknown."""
        peak = self.flops_peak()
        if achieved_flops_per_s is None or not peak:
            return None
        return float(achieved_flops_per_s) / (self.n_devices * peak)

    def mbu(self, achieved_bytes_per_s) -> float | None:
        if (achieved_bytes_per_s is None or self.peaks is None
                or not self.peaks.hbm_bytes_per_s):
            return None
        return (float(achieved_bytes_per_s)
                / (self.n_devices * self.peaks.hbm_bytes_per_s))

    def describe(self) -> dict:
        """The device half of every roofline report section."""
        return {
            "device_kind": (self.peaks.device_kind if self.peaks
                            else None),
            "known_device": self.peaks is not None,
            "peak_table_revision": self.revision,
            "n_devices": self.n_devices,
            "dtype": self.dtype,
            "peak_flops_per_sec": self.flops_peak(),
            "peak_hbm_bytes_per_sec": (self.peaks.hbm_bytes_per_s
                                       if self.peaks else None),
            "ridge_flops_per_byte": ridge_point(self.peaks, self.dtype),
        }
