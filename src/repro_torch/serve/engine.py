"""Serving: prefill/decode steps, sampling, and a continuous batcher
(port of the fused path of ``repro/serve/engine.py``).

The ``ContinuousBatcher`` keeps a fixed pool of slots; finished
sequences are replaced from the queue at once. One batched
ragged-position ``decode_step`` serves every slot per step; newly
assigned slots prefill together in one left-padded, pow2-bucketed batch;
sampling runs on the device and the host fetches one small token vector
per step (``host_syncs``). On the card the decode step and the prefill
of each bucket run as captured CUDA graphs (``serve.graph``), the
counterparts of the reference's jitted steps. ``fused=False`` serves
the reference's per-slot loop instead, the measured baseline of the old
formulation. The caches are KV or MLA caches (bf16 or quantized,
``cache_dtype``), SSM caches, or hybrid's pair of them, walked leaf by
leaf with ``transformer.map_caches``/``cache_leaves``; nothing here is
specific to a family (the moe family's routing is inside its step).
``serve_step`` and ``make_jit_serve_step`` are the reference's
single-step entry points; they, ``prefill`` and ``generate`` take
encdec's encoder output ``enc``, which the batcher does not (as in the
reference, the batcher serves whisper as its decoder without cross
attention, and llava as its token stream). ``ContinuousBatcher(profile=)``
records one trace event per decode step, per fill batch and per weight
preparation (``repro_torch.profile``). ``ContinuousBatcher(mesh=)``
serves tensor-parallel: each rank of a ``launch.mesh.TPMesh`` runs the
same batcher on its shard (every family), eagerly.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.execution import CiMExecSpec, get_backend, no_kernel_events
from repro_torch.models import transformer as T
from repro_torch.serve.graph import CapturedStep


def apply_exec_spec(cfg: ArchConfig, spec: Optional[CiMExecSpec]) -> ArchConfig:
    """Serve the model under an explicit CiM execution spec: the spec
    overrides the QuantConfig's mode-derived dispatch in every dense
    layer. Noisy specs are rejected (serving threads no generator into
    the dense layers)."""
    if spec is None:
        return cfg
    if spec.error_prob > 0.0:
        raise ValueError(
            "serving does not thread generators into dense layers; use a "
            "spec with error_prob=0 here and drive the sensing-error channel "
            "through execution.execute/layers.dense directly")
    if spec.packing != "none":
        warnings.warn(
            f"serving under packing={spec.packing!r} packs weights "
            "per-forward (functional path only); use "
            "quant.prepare.prepare_for_spec + execute_packed for the "
            "stored-plane path", stacklevel=2)
    mode = "cim" if cfg.quant.mode == "off" else cfg.quant.mode
    return cfg.replace(
        quant=dataclasses.replace(cfg.quant, mode=mode, exec_spec=spec))


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           temperature: float = 0.0) -> torch.Tensor:
    """logits: (B, 1, V) -> token ids (B, 1), on the logits' device."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits[:, 0, :].to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)


def prefill(params, tokens: torch.Tensor, caches, cfg: ArchConfig,
            enc: Optional[torch.Tensor] = None):
    """Run the prompt through the cached path at index 0 (``enc``:
    encdec's encoder output). Returns (last_logits (B, 1, V), caches)."""
    logits, caches = T.decode_step(params, tokens, caches, 0, cfg, enc=enc)
    return logits[:, -1:, :], caches


def serve_step(params, tokens: torch.Tensor, caches, index, cfg: ArchConfig,
               start: Optional[torch.Tensor] = None,
               enc: Optional[torch.Tensor] = None):
    """One decode step: tokens (B, S) at cache position ``index`` (a
    Python int or a (B,) tensor; ``start`` (B,) the rows' left-pad dead
    zones; ``enc`` (B, S_enc, D) encdec's encoder output). The caches are
    updated in place. Returns (logits (B, S, V), caches)."""
    return T.decode_step(params, tokens, caches, index, cfg, start=start, enc=enc)


def make_jit_serve_step(cfg: ArchConfig):
    """:func:`serve_step` as a captured CUDA graph:
    ``f(params, tokens, caches, index, start=None, enc=None) -> (logits,
    caches)``.

    On a CUDA device the first call for a (batch, step length, with or
    without ``start``, with or without ``enc``) warms up on a side stream
    and captures the step into a ``torch.cuda.CUDAGraph``
    (``serve.graph.CapturedStep``); later calls copy their tokens, index,
    start and enc into the graph's static tensors and replay it, so the
    cross attention's K and V are projected from the copied ``enc`` on
    every replay, as the reference recomputes them every step. The caches
    are updated in place (the counterpart of the reference's donated
    caches), and a graph is bound to the params and caches of its first
    call and to the shape and dtype of its ``enc``: a call with others
    raises. The logits returned are a copy of the graph's output. On the
    CPU (no graphs) every call is :func:`serve_step`. No call records a
    kernel event (``core.execution.no_kernel_events``)."""
    steps: Dict[tuple, tuple] = {}

    def f(params, tokens, caches, index, start=None, enc=None):
        if tokens.device.type != "cuda":
            with no_kernel_events():
                return serve_step(params, tokens, caches, index, cfg, start=start,
                                  enc=enc)
        b, s = tokens.shape
        if not torch.is_tensor(index):
            index = torch.full((b,), int(index), dtype=torch.int64,
                               device=tokens.device)
        index = index.expand(b)
        ints = (tokens, index) if start is None else (tokens, index, start)
        args = ints if enc is None else ints + (enc,)
        key = (b, s, start is not None, enc is not None)
        if key not in steps:
            def body(tok, idx, *rest):
                st = rest[0] if start is not None else None
                e = rest[-1] if enc is not None else None
                return serve_step(params, tok, caches, idx, cfg, start=st, enc=e)[0]

            inputs = [a.to(device=tokens.device, dtype=torch.int64).clone()
                      for a in ints]
            if enc is not None:
                inputs.append(enc.to(tokens.device).clone())
            steps[key] = (params, caches, CapturedStep(body, inputs, tokens.device))
        bound_params, bound_caches, step = steps[key]
        if params is not bound_params or any(
                mine.data_ptr() != bound.data_ptr()
                for mine, bound in zip(T.cache_leaves(caches),
                                       T.cache_leaves(bound_caches))):
            raise ValueError("a captured serve step is bound to the params and "
                             "caches of its first call")
        if enc is not None and (enc.shape != step.inputs[-1].shape
                                or enc.dtype != step.inputs[-1].dtype):
            raise ValueError(
                f"a captured serve step is bound to the enc of its first call: "
                f"{tuple(step.inputs[-1].shape)} {step.inputs[-1].dtype}, got "
                f"{tuple(enc.shape)} {enc.dtype}")
        for static, a in zip(step.inputs, args):
            static.copy_(a)
        return step().clone(), caches

    return f


def fused_decode_fn(cfg: ArchConfig, temperature: float = 0.0):
    """The function the fused batcher runs for every decode step: one
    ragged-position ``decode_step`` over all slots plus on-device
    sampling; tokens out are the step's only device->host payload."""

    def step(params, tokens, caches, positions, start, generator):
        logits, caches = serve_step(params, tokens, caches, positions, cfg,
                                    start=start)
        return sample(logits[:, -1:, :], generator, temperature)[:, 0], caches

    return step


def _params_to(params, device: torch.device):
    return {k: _params_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in params.items()}


def generate(params, prompt, cfg: ArchConfig, max_new: int = 16,
             s_max: int = 128, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             exec_spec: Optional[CiMExecSpec] = None,
             device: DeviceLike = None,
             enc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy/temperature generation for a (B, S) prompt on ``device``
    (default ``cuda``; raises without CUDA unless ``device="cpu"``),
    attending to encdec's encoder output ``enc`` (B, S_enc, D) at every
    step where it is given. Returns (B, max_new) token ids."""
    dev = resolve_device(device)
    cfg = apply_exec_spec(cfg, exec_spec)
    params = _params_to(params, dev)
    prompt = torch.as_tensor(prompt, dtype=torch.int64).to(dev)
    if enc is not None:
        enc = enc.to(dev)
    b, s0 = prompt.shape
    caches = T.init_caches(cfg, b, s_max, device=dev)
    logits, caches = prefill(params, prompt, caches, cfg, enc)
    tok = sample(logits, generator, temperature)
    out = [tok]
    for i in range(max_new - 1):
        logits, caches = T.decode_step(params, tok, caches, s0 + i, cfg, enc=enc)
        tok = sample(logits, generator, temperature)
        out.append(tok)
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# Continuous batching
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    """One generation request: ``prompt`` token ids, up to ``max_new``
    tokens out (into ``generated``); ``done``, ``truncated`` and
    ``cancelled`` say how it ended."""

    rid: int
    prompt: List[int]
    max_new: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # the slot hit cache capacity (s_max) before max_new tokens; the
    # left-pad dead zone of a batched prefill counts against capacity
    truncated: bool = False
    # withdrawn by ContinuousBatcher.cancel() before max_new tokens
    cancelled: bool = False


def check_prompt(prompt: List[int], vocab: int, s_max: int) -> None:
    """Raise ValueError unless a batcher of ``vocab`` tokens and cache
    capacity ``s_max`` can serve ``prompt``: not empty, every id in the
    vocabulary, and one decode slot left after it."""
    if not prompt:
        raise ValueError("empty prompt: serving needs at least one prompt token")
    bad = [t for t in prompt if not 0 <= t < vocab]
    if bad:
        # an out-of-range index would fail inside a step on the card
        raise ValueError(f"prompt token ids {bad[:4]} outside the "
                         f"vocabulary [0, {vocab})")
    if len(prompt) >= s_max:
        raise ValueError(
            f"prompt length {len(prompt)} does not fit a cache of "
            f"s_max={s_max} (needs at least one decode slot)")


def _next_pow2(n: int, lo: int = 4) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


class ContinuousBatcher:
    """Slot-pool continuous batcher over one fused decode step.

    Each slot owns a cache row (axis 1 of the stacked caches). Per step,
    one batched ``decode_step`` serves every slot at its own position via
    an ``(n_slots,)`` position vector; newly assigned slots prefill
    together, left-padded (prompts right-aligned, a per-row ``start``
    masks the pad dead zone for the slot's lifetime) to a power-of-two
    length, against fresh caches that are merged into the filled rows
    under a fill mask (the reference's ``pf``). Sampling runs on the
    device: one host fetch per step and per fill batch (``host_syncs``).

    On a CUDA device the decode step is one captured CUDA graph of
    :func:`fused_decode_fn` (``serve.graph.CapturedStep``), captured at
    the first decode step and replayed at every later one: per step the
    host copies the tokens, positions and starts from pinned buffers into
    the graph's static tensors, replays it, and fetches the tokens. The
    prefill is one captured graph per bucket (and per exact length where
    the bucket would reach ``s_max``), built at that bucket's first fill
    (its warm-up) and replayed at every later one: the host copies the
    left-padded tokens, the starts and the fill mask from pinned buffers
    into its static tensors; the graph resets the fresh caches (allocated
    once per batcher), prefills every row against them at index 0,
    samples each row's first token, and merges the filled rows into
    ``self.caches`` in place. The caches (KV, MLA, SSM, or hybrid's pair
    of them; every leaf has its slots on axis 1) keep their storage for
    the batcher's life. The batcher's graphs share one memory pool.
    Sampling is part of the graphs: at ``temperature > 0`` the batcher's
    generator is registered with every one of them, so a replay draws
    what the eager call would and prefill and decode draws continue one
    sequence (each graph's warm-up is its first call itself, so nothing
    is drawn twice). ``capture_seconds`` is the decode capture's wall
    time and ``prefill_capture_seconds`` the prefill captures' sum (None
    before them, and on the CPU, where the same functions run eagerly on
    the same static tensors). ``graphed = False`` switches every graph
    off (the eager yardstick).

    ``prepare_weights=True`` runs ``quant.prepare.prepare_for_spec`` once:
    the model serves folded ternary weights (``pre_quantized``), and for
    a bitplane-packed spec the canonical 2-bit planes are kept on
    ``self.packed`` for ``execute_packed`` consumers (layout 1 for a
    ``cuda_stream`` spec) while the in-model spec drops to
    ``packing="none"`` (as in the reference, the model itself never reads
    the planes). A backend with no dense kernel for the formulation
    (``cuda_stream`` exists to stream stored planes) serves the dense
    path under ``auto``, as the reference does: on the card that is the
    ``cuda`` kernel. A formulation with no dense kernel at all raises
    ``KeyError`` here.

    ``cache_dtype`` overrides ``cfg.quant.cache_dtype``: "bf16" (the
    config's default) stores k/v as they are; "int8" and "ternary" store
    codes with one f32 scale per (row, position)
    (``attention.QuantKVCache``, MLA's ``QuantMLACache``), quantized on
    write and dequantized
    inside the attention contractions. Prefill's fresh caches follow it,
    so a refilled slot is rebuilt in that layout: zero codes (ternary:
    bytes 0x11) and scales 1.0 beyond what its prefill wrote.

    A slot freed at capacity (``slot_pos == s_max``) keeps riding the
    batched step as a dead lane until it is refilled; its cache write is
    clamped to the last slot of its own row, as the reference's
    ``dynamic_update_slice`` clamps it, and its tokens are discarded.

    Fused serving is token-identical to :func:`generate` under
    ``QuantConfig(act_scale="per_row")``; the per-tensor scale couples
    co-batched rows through one amax.

    ``fused=False`` is the reference's looped baseline, greedy only
    (``temperature > 0`` raises): each new request prefills its slot
    alone at index 0 with no left pad, from a fresh cache row (the
    reference continues a refilled SSM row from its old state), one
    prefill batch per slot, and
    each decode step is a loop of single-row :func:`serve_step` calls,
    one per slot, each writing its slot's row of the stacked caches in
    place; the host fetches each active slot's token on its own (one
    host sync per active slot). It runs eagerly, with no graph.

    ``mesh`` (a ``launch.mesh.TPMesh``) serves tensor-parallel: every
    rank of the mesh builds this batcher from the same whole params, the
    same requests and the same seed, and keeps its shard (cut where the
    params are: a whole tree on the host stays there, and only the shard
    moves to ``device``; ``dist.sharding.shard_params``: q/k/v, gate and up column-parallel,
    o and down row-parallel, mamba's heads, MLA's heads, the experts,
    the vocabulary split; ``self.cfg`` is the rank's config,
    ``local_config``) and its caches (its kv heads, its SSM channels and
    heads, the whole MLA latent). The ranks meet in the model's
    collectives (``dist.collectives``): they compute the same logits and
    sample the same tokens, so in a quantized mode each rank's
    ``generated`` and ``stats()`` equal the single-device batcher's; in
    mode "off" the row-parallel layers sum float partials, equal to one
    device's up to float summation order. Every family splits (encdec
    and vlm serve their decoders, as on one device). gloo
    runs its collectives from the host, and a captured CUDA graph cannot
    hold one, so under a mesh the decode and prefill steps run eagerly
    (``graphed`` stays False); capturing the segments between
    collectives is later work. ``compress_tp=True`` (quantized modes,
    unpacked specs; needs the mesh) sums the row-parallel partials
    through the int8-compressed collective (``QuantConfig.tp_reduce``):
    quantization-level error, the exact sum is the default.

    ``profile`` (a ``repro_torch.profile.Profiler``, or a path that the
    batcher opens one on and closes at the end of :meth:`run`) times
    every call of a fused step, as the reference times its jitted ones:
    one ``serve.decode_step`` event per decode step (meta: arch, step,
    occupancy and n_slots, read before the step changes the slots), one
    ``serve.prefill`` per fill batch (meta: arch, the prompts as (rid,
    length, max_new), s_pad, filled) and one ``serve.prepare`` for
    ``prepare_weights``. The wrapper goes around the call of the
    captured step, so a replay is timed, and a graph's first call, its
    warm-up and capture, as the reference's first call is its compile.
    With ``profile=None`` the batcher holds no wrapper. The looped
    baseline is not timed (the reference's neither).

    Runs on ``device`` (default ``cuda``; raises without CUDA unless
    ``device="cpu"``).
    """

    def __init__(self, params, cfg: ArchConfig, n_slots: int = 4,
                 s_max: int = 128, exec_spec: Optional[CiMExecSpec] = None,
                 temperature: float = 0.0, seed: int = 0, fused: bool = True,
                 prepare_weights: bool = False, device: DeviceLike = None,
                 cache_dtype: Optional[str] = None, profile=None, mesh=None,
                 compress_tp: bool = False):
        if mesh is not None and "model" not in mesh.axis_names:
            raise ValueError(
                f"TP serving shards over a 'model' mesh axis; got axes "
                f"{mesh.axis_names} (use launch.mesh.make_tp_mesh)")
        if compress_tp and mesh is None:
            raise ValueError("compress_tp=True requires a mesh (TP serving)")
        self.mesh = mesh
        self._mesh_dict = None if mesh is None else dict(mesh.shape)
        self.device = dev = resolve_device(device)
        self.profiler = None
        self._owns_profiler = False
        if profile is not None:
            from repro_torch.profile.trace import Profiler

            if isinstance(profile, Profiler):
                self.profiler = profile
            else:
                self.profiler = Profiler(profile)
                self._owns_profiler = True
        if not fused and temperature != 0.0:
            raise ValueError(
                "temperature sampling is only implemented for the fused "
                "decode path (the looped baseline is greedy-only)")
        self.packed = None
        if prepare_weights and exec_spec is None:
            raise ValueError(
                "prepare_weights=True requires exec_spec (the surgery is "
                "matched to the spec's packing)")
        if mesh is None or prepare_weights:
            params = _params_to(params, dev)
        if prepare_weights:
            from repro_torch.quant.prepare import prepare_for_spec

            prepare = self._timed(
                lambda: prepare_for_spec(params, exec_spec, mesh=mesh), "serve.prepare",
                exec_spec=exec_spec.name, shape_class="prepare")
            prepared = prepare()
            if exec_spec.packing == "bitplane_u8":
                params, self.packed = prepared
                # the in-model dense path serves the folded ternary weights;
                # a packed-only backend (cuda_stream) serves it under auto,
                # i.e. the dense kernel on the card, and a formulation
                # with no kernel on this device raises here
                exec_spec = dataclasses.replace(exec_spec, packing="none")
                try:
                    get_backend(exec_spec, dev)
                except KeyError:
                    exec_spec = dataclasses.replace(exec_spec, backend="auto")
                    get_backend(exec_spec, dev)
            else:
                params = prepared
            cfg = cfg.replace(
                quant=dataclasses.replace(cfg.quant, pre_quantized=True))
        self.cfg = cfg = apply_exec_spec(cfg, exec_spec)
        if cache_dtype is not None:
            # validated by QuantConfig.__post_init__
            self.cfg = cfg = cfg.replace(
                quant=dataclasses.replace(cfg.quant, cache_dtype=cache_dtype))
        if compress_tp:
            if cfg.quant.mode == "off":
                raise ValueError(
                    "compress_tp compresses the quantized dense path's TP "
                    "all-reduce; serve a quantized mode (or an exec_spec) to use it")
            spec_now = cfg.quant.exec_spec
            if spec_now is not None and spec_now.packing != "none":
                raise ValueError(
                    f"compress_tp cannot engage under packing={spec_now.packing!r}: "
                    "use prepare_weights=True (which folds the packing offline "
                    "and serves the dense path unpacked) or an unpacked spec")
            self.cfg = cfg = cfg.replace(
                quant=dataclasses.replace(cfg.quant, tp_reduce="int8"))
        if mesh is not None:
            from repro_torch.dist.sharding import local_config, shard_params

            # cut where the params are (a host tree stays there), and move
            # only this rank's shard to the device
            params = shard_params(params, cfg, mesh, device=dev)
            self.cfg = cfg = local_config(cfg, mesh)
        self.params = params
        self.fused = fused
        self.n_slots = n_slots
        self.s_max = s_max
        self.temperature = float(temperature)
        self._generator = torch.Generator(device=dev).manual_seed(seed)
        self.caches = T.init_caches(cfg, n_slots, s_max, device=dev)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        # the decode step's inputs: host buffers (pinned on the card) that
        # the step copies into the static device tensors of its graph
        pinned = dev.type == "cuda"
        host = [torch.zeros((n_slots,), dtype=torch.int64, pin_memory=pinned)
                for _ in range(3)]
        # analysis: host-sync ok -- numpy views of host (pinned) buffers: no device read
        self._last_tok, self.slot_pos, self.slot_start = (h.numpy() for h in host)
        # slot_pos: the next cache write slot; slot_start: the left-pad dead zone
        self._host_inputs = (host[0][:, None], host[1], host[2])
        self.queue: List[Request] = []
        self.decode_steps = 0
        self.host_syncs = 0
        self.prefill_batches = 0
        self._decode = None
        if not fused:
            return
        self._pool = torch.cuda.graph_pool_handle() if pinned else None
        self._generators = (self._generator,) if self.temperature else ()
        step = fused_decode_fn(cfg, self.temperature)
        params, caches, generator = self.params, self.caches, self._generator
        self._decode = CapturedStep(
            lambda tokens, positions, start: step(
                params, tokens, caches, positions, start, generator)[0],
            [h.to(dev, copy=True) for h in self._host_inputs], dev,
            generators=self._generators, pool=self._pool)
        # gloo's collectives run from the host: no graph can hold them
        self._decode.graphed = self._decode.graphed and mesh is None
        # read at record time, before _step changes the slots: occupancy
        # is the number of rows this step decoded for
        self._run_decode = self._timed(
            self._decode, "serve.decode_step", meta_fn=lambda: {
                "arch": self.cfg.name, "step": self.decode_steps,
                "occupancy": sum(r is not None for r in self.slot_req),
                "n_slots": self.n_slots})
        # the prefill's fresh caches, reset from a one-row template in
        # every prefill; its inputs: the starts and the fill mask (host
        # buffers and their static copies, shared by every bucket's graph),
        # and per bucket the left-padded tokens (_prefill_steps)
        self._fresh = T.init_caches(cfg, n_slots, s_max, device=dev)
        self._fresh_row = T.init_caches(cfg, 1, s_max, device=dev)
        self._fill_host = (
            torch.zeros((n_slots,), dtype=torch.int64, pin_memory=pinned),
            torch.zeros((n_slots,), dtype=torch.bool, pin_memory=pinned))
        self._fill_static = tuple(h.to(dev, copy=True) for h in self._fill_host)
        self._prefill_steps: Dict[int, tuple] = {}

    def _timed(self, fn, entry_point: str, exec_spec: Optional[str] = None,
               shape_class: str = "decode", meta_fn=None):
        """``fn`` wrapped by ``profile.trace.wrap_step`` for this
        batcher's profiler: ``fn`` itself when there is none."""
        if self.profiler is None:
            return fn
        from repro_torch.profile.trace import wrap_step

        return wrap_step(fn, self.profiler, entry_point,
                         exec_spec=exec_spec or self.spec_tag,
                         shape_class=shape_class, mesh=self._mesh_dict,
                         meta_fn=meta_fn)

    @property
    def spec_tag(self) -> str:
        """The trace events' exec_spec: the spec's name, or "mode:<quant mode>"."""
        spec = self.cfg.quant.exec_spec
        return spec.name if spec is not None else f"mode:{self.cfg.quant.mode}"

    @property
    def capture_seconds(self) -> Optional[float]:
        return None if self._decode is None else self._decode.capture_seconds

    @property
    def prefill_capture_seconds(self) -> Optional[float]:
        """The summed wall time of the prefill graphs' warm-ups and
        captures (None before the first)."""
        times = [step.capture_seconds for _, step in self._prefill_steps.values()
                 if step.capture_seconds is not None]
        return sum(times) if times else None

    @property
    def graphed(self) -> bool:
        return self._decode is not None and self._decode.graphed

    @graphed.setter
    def graphed(self, on: bool) -> None:
        """Switch the decode graph and every prefill graph, built or yet
        to be built, on or off (off: the same functions run eagerly). A
        TP batcher's steps stay eager."""
        if on and self.mesh is not None:
            raise ValueError("a TP batcher's steps run eagerly: gloo's "
                             "collectives cannot be captured in a CUDA graph")
        self._decode.graphed = on
        for _, step in self._prefill_steps.values():
            step.graphed = on

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        # called between steps, after the previous step's fetch: the
        # device is idle, so a plain copy stalls nothing
        return torch.from_numpy(arr).to(self.device)

    def _prefill(self, tokens, start, fill):
        """The reference's ``pf``: reset the fresh caches to the
        ``cache_dtype`` layout's initial values, prefill all n_slots rows
        against them at index 0 (dummy rows compute garbage), sample each
        row's first token, and merge the filled rows (``fill``, a bool
        per slot) into every cache leaf in place: the caches keep their
        storage, which the graphs hold."""
        fresh = self._fresh
        for leaf, row in zip(T.cache_leaves(fresh), T.cache_leaves(self._fresh_row)):
            leaf.copy_(row.expand_as(leaf))
        logits, fresh = T.decode_step(self.params, tokens, fresh, 0, self.cfg,
                                      start=start)
        # left-padding: the last column is every row's last real token
        toks = sample(logits[:, -1:, :], self._generator, self.temperature)[:, 0]
        for old, new in zip(T.cache_leaves(self.caches), T.cache_leaves(fresh)):
            mask = fill.view((1, -1) + (1,) * (old.dim() - 2))
            torch.where(mask, new, old, out=old)
        return toks

    def _prefill_step(self, s_pad: int):
        """The prefill graph of a ``s_pad``-token bucket and the pinned
        host buffer of its tokens, made at the bucket's first fill."""
        if s_pad not in self._prefill_steps:
            host = torch.zeros((self.n_slots, s_pad), dtype=torch.int64,
                               pin_memory=self.device.type == "cuda")
            step = CapturedStep(self._prefill,
                                (host.to(self.device, copy=True),) + self._fill_static,
                                self.device, generators=self._generators,
                                pool=self._pool)
            step.graphed = self._decode.graphed
            self._prefill_steps[s_pad] = (host, step)
        return self._prefill_steps[s_pad]

    def _fill_slots(self):
        newly = []
        for s in range(self.n_slots):
            if self.slot_req[s] is None and self.queue:
                self.slot_req[s] = self.queue.pop(0)
                newly.append(s)
        if not newly:
            return
        max_len = max(len(self.slot_req[s].prompt) for s in newly)
        s_pad = _next_pow2(max_len)  # bucketed prefill lengths
        if s_pad >= self.s_max:
            # don't let the bucket make a servable prompt unservable
            s_pad = max_len
        host, step = self._prefill_step(s_pad)
        # analysis: host-sync ok -- numpy views of host (pinned) buffers: no device read
        tokens, start, fill = (h.numpy() for h in (host,) + self._fill_host)
        tokens[:], start[:], fill[:] = 0, 0, False
        for s in newly:
            prompt = self.slot_req[s].prompt
            pad = s_pad - len(prompt)
            tokens[s, pad:] = prompt
            start[s] = pad
            fill[s] = True
        for static, h in zip(step.inputs, (host,) + self._fill_host):
            static.copy_(h, non_blocking=True)
        run = step
        if self.profiler is not None:
            meta = {"arch": self.cfg.name,
                    "prompts": [(self.slot_req[s].rid, len(self.slot_req[s].prompt),
                                 self.slot_req[s].max_new) for s in newly],
                    "s_pad": s_pad, "filled": len(newly)}
            run = self._timed(step, "serve.prefill", shape_class="prefill",
                              meta_fn=lambda: meta)
        toks = run().cpu().numpy()  # analysis: host-sync ok -- the one fetch of a fill batch
        self.host_syncs += 1
        self.prefill_batches += 1
        for s in newly:
            self._admit(s, int(toks[s]), s_pad, start[s])

    def _admit(self, s: int, tok: int, pos: int, start: int) -> None:
        """Record slot ``s``'s first token (from its prefill); its next
        cache write is at ``pos``, its dead zone below ``start``."""
        req = self.slot_req[s]
        req.generated.append(tok)
        self._last_tok[s] = tok
        self.slot_pos[s] = pos
        self.slot_start[s] = start
        if len(req.generated) >= req.max_new:
            req.done = True
            self.slot_req[s] = None

    def _advance(self, s: int, tok: int) -> None:
        """Record slot ``s``'s decoded token; free the slot when its
        request is done or its cache is full."""
        req = self.slot_req[s]
        req.generated.append(tok)
        self._last_tok[s] = tok
        self.slot_pos[s] += 1
        # slot_pos is the NEXT write offset: the last cache slot is usable
        if len(req.generated) >= req.max_new or self.slot_pos[s] >= self.s_max:
            req.done = True
            req.truncated = len(req.generated) < req.max_new
            self.slot_req[s] = None

    def _step(self, active) -> int:
        for static, host in zip(self._decode.inputs, self._host_inputs):
            static.copy_(host, non_blocking=True)
        toks = self._run_decode()
        self.decode_steps += 1
        toks = toks.cpu().numpy()  # analysis: host-sync ok -- the one fetch of a decode step
        self.host_syncs += 1
        for s in active:
            self._advance(s, int(toks[s]))
        return len(active)

    # -- the looped baseline (fused=False) ------------------------------------

    def _row_caches(self, s: int):
        """Slot ``s``'s row of every stacked cache leaf, as views: a step
        on them writes the stacked caches in place."""
        return T.map_caches(lambda leaf: leaf[:, s:s + 1], self.caches)

    def _fill_slots_looped(self):
        for s in range(self.n_slots):
            if self.slot_req[s] is None and self.queue:
                req = self.slot_req[s] = self.queue.pop(0)
                prompt = torch.tensor([req.prompt], dtype=torch.int64,
                                      device=self.device)
                # the row starts from fresh caches, as a fused refill does:
                # an SSM prefill continues from the row's state
                row = self._row_caches(s)
                fresh = T.init_caches(self.cfg, 1, self.s_max, device=self.device)
                for old, new in zip(T.cache_leaves(row), T.cache_leaves(fresh)):
                    old.copy_(new)
                logits, _ = prefill(self.params, prompt, row, self.cfg)
                # analysis: host-sync ok -- the looped baseline fetches each slot's token
                tok = int(torch.argmax(logits[0, -1]))
                self.host_syncs += 1
                self.prefill_batches += 1
                self._admit(s, tok, len(req.prompt), 0)

    def _step_looped(self, active) -> int:
        tokens = self._to_device(self._last_tok[:, None])
        logits = [serve_step(self.params, tokens[s:s + 1], self._row_caches(s),
                             int(self.slot_pos[s]), self.cfg)[0]
                  for s in range(self.n_slots)]
        toks = torch.argmax(torch.cat(logits)[:, 0, :], dim=-1)
        self.decode_steps += 1
        for s in active:
            self._advance(s, int(toks[s]))  # one host sync per active slot
            self.host_syncs += 1
        return len(active)

    def submit(self, req: Request):
        check_prompt(req.prompt, self.cfg.vocab, self.s_max)
        self.queue.append(req)

    def cancel(self, request_id: int) -> bool:
        """Withdraw a request by rid: drop it from the queue, or free its
        slot if it is mid-decode (the row rides on as a dead lane until
        refilled). Returns False when rid is not in flight."""
        for i, req in enumerate(self.queue):
            if req.rid == request_id:
                del self.queue[i]
                req.done = True
                req.cancelled = True
                return True
        for s in range(self.n_slots):
            req = self.slot_req[s]
            if req is not None and req.rid == request_id:
                req.done = True
                req.cancelled = True
                req.truncated = len(req.generated) < req.max_new
                self.slot_req[s] = None
                return True
        return False

    def step(self) -> int:
        """One decode step over all active slots; returns #active. No
        ``execute`` call inside records a kernel event."""
        with no_kernel_events():
            (self._fill_slots if self.fused else self._fill_slots_looped)()
            active = [s for s in range(self.n_slots) if self.slot_req[s] is not None]
            if not active:
                return 0
            return (self._step if self.fused else self._step_looped)(active)

    def stats(self) -> Dict[str, int]:
        return {
            "decode_steps": self.decode_steps,
            "host_syncs": self.host_syncs,
            "prefill_batches": self.prefill_batches,
        }

    def run(self) -> None:
        try:
            while self.queue or any(r is not None for r in self.slot_req):
                self.step()
        finally:
            if self._owns_profiler:
                # the batcher opened the trace file (profile=<path>); the
                # profiler flushes per event, so the file is whole
                self.profiler.close()


# ---------------------------------------------------------------------------
# Tracing contracts (repro_torch.analysis)
#
# The serving invariants, declared where the fused step lives:
#
#   * the fused decode step is ONE batched program: its op count is
#     invariant to the slot count and the TP degree (the per-slot python
#     work of the looped baseline must never leak back into the step);
#   * no host sync and no host->device copy inside the step: the single
#     documented host fetch (``toks.cpu().numpy()``) happens after the
#     step returned, and a captured CUDA graph can hold neither;
#   * no pad on uint8 operands: stored 2-bit planes enter kernels in
#     their prepare-time canonical layout.
# ---------------------------------------------------------------------------

from repro_torch.analysis.contracts import (  # noqa: E402
    OpRule,
    TraceContract,
    rank_mesh,
    register_trace_contract,
)


def fused_step_point(quant_mode: str, cache_dtype: str = "bf16", s_max: int = 32,
                     *, cfg: Optional[ArchConfig] = None, params=None,
                     device: DeviceLike = "cpu"):
    """``build(n_slots, tp) -> (fn, args)`` running the production fused
    decode step (:func:`fused_decode_fn`) once: on the smoke serving arch
    under ``quant_mode`` (weights) and ``cache_dtype`` (KV cache), seeded
    params, on the CPU, or on ``cfg`` with ``params`` on ``device``
    (``chip_smoke.py`` audits the full-size step on the card so). A
    ``tp`` > 1 combination runs in a rank of a spawned group
    (``contracts.rank_mesh``) on the rank's shard and caches, as a TP
    batcher's step does."""

    def build(n_slots: int = 3, tp: int = 1):
        mesh = rank_mesh(tp) if tp > 1 else None
        dev = resolve_device(device)
        c = cfg
        if c is None:
            from repro_torch.models.layers import QuantConfig
            from repro_torch.models.registry import get_config

            c = get_config("smollm-135m", smoke=True).replace(
                quant=QuantConfig(mode=quant_mode, cache_dtype=cache_dtype))
        p = params if params is not None else T.init_params(c, seed=0, device=dev)
        if mesh is not None:
            from repro_torch.dist.sharding import local_config, shard_params

            p = shard_params(p, c, mesh, device=dev)
            c = local_config(c, mesh)
        caches = T.init_caches(c, n_slots, s_max, device=dev)
        ints = [torch.zeros(shape, dtype=torch.int64, device=dev)
                for shape in ((n_slots, 1), (n_slots,), (n_slots,))]
        args = (p, ints[0], caches, ints[1], ints[2],
                torch.Generator(device=dev).manual_seed(1))
        return fused_decode_fn(c), args

    return build


_FUSED_STEP_CONTRACT = TraceContract(
    max_host_syncs=0,
    max_host_to_device=0,
    no_pad_on_dtypes=("uint8",),
)

register_trace_contract(
    "serve.fused_decode_step",
    fused_step_point("off"),
    _FUSED_STEP_CONTRACT,
    axes={"n_slots": (2, 6), "tp": (1, 2, 4)},
)

register_trace_contract(
    "serve.fused_decode_step.cim",
    fused_step_point("cim"),
    _FUSED_STEP_CONTRACT,
    axes={"n_slots": (2, 6)},
)


# Quantized KV cache: the fused step over an int8 cache must never
# materialize a full-precision copy of the *stacked* cache: dequant stays
# per layer (one layer's codes at a time). The regression this rule
# catches is cache-level dequant: an integer code tensor shaped like the
# *stacked* cache (rank 5 with the contract's s_max at axis 2, picked to
# collide with no legitimate dimension of the smoke arch) converted to a
# float tensor. Matching on the op's integer *input* keeps legitimate
# rank-5 float activations out of scope.
_KVQ_S_MAX = 48


def _kvq_stacked_dequant(rec) -> bool:
    def stacked(t, kinds):
        return t.dtype in kinds and len(t.shape) == 5 and t.shape[2] == _KVQ_S_MAX

    # int/uint stacked codes in AND a float tensor of the same stacked
    # shape out = the cache-level dequant
    if not any(stacked(t, ("int8", "uint8")) for t in rec.inputs):
        return False
    return any(stacked(t, ("float16", "bfloat16", "float32", "float64"))
               for t in rec.outputs)


register_trace_contract(
    "serve.fused_decode_step.kvq",
    fused_step_point("off", cache_dtype="int8", s_max=_KVQ_S_MAX),
    TraceContract(
        max_host_syncs=0,
        max_host_to_device=0,
        # int8 codes and ternary-packed uint8 planes both enter the
        # attention contractions in their stored layout: zero relayout
        no_pad_on_dtypes=("uint8", "int8"),
        forbid_ops=(
            OpRule(
                rule="kvq-stacked-dequant",
                when=_kvq_stacked_dequant,
                reason="full-precision copy of the stacked quantized KV "
                       "cache -- dequant must stay per layer in the "
                       "attention contractions",
            ),
        ),
        # a future hand-written attention kernel must accumulate f32
        accum_dtype="float32",
    ),
    axes={"n_slots": (2, 6), "tp": (1, 2)},
)
