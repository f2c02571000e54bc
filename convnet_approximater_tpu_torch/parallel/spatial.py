"""Spatial sharding of eval forwards across processes (port of
``spatial_sharding`` in ``convnet_approximater_tpu/parallel/mesh.py``).

The JAX package lays an NHWC batch out with its batch over the mesh's
``data`` axis and its image rows over the ``model`` axis, and XLA gives every
spatially sharded convolution the halo exchange it needs.  Here a rank is a
process holding its rows of every map, and no compiler inserts anything:
:func:`spatial_module` gives each spatial layer a row-sharded form as an
instance ``forward`` (its class stays, so the kernel layers' ``type(m) is
Conv2d`` checks still hold), and each form fetches from the ranks that own
them the rows its own output rows need:

* a ``Conv2d`` of any kernel height, stride, padding and groups: its owned
  output rows need input rows ``[o0 s - p, (o1 - 1) s - p + k)``, fetched and
  zero-padded at the true image edges only.  A stride-1 "same" conv whose
  shard is at least twice its halo runs on the rank's own rows and
  recomputes its edge rows from small windows (no copy of the whole map:
  the FFN's hidden map is the forward's peak);
* ``MSCA`` on ``msca_fused`` and the strip bank on ``parallel_cascade``: one
  kernel call on a window of the rank's rows plus ``k_max // 2 + k0 // 2``
  (``k_max // 2``) halo rows on each side, clipped to the image (the kernel
  zero-pads outside its map, which is then the image's edge), of which the
  rank keeps its own rows.  The border fix's strips are remapped per window
  on the host (:func:`window_fix`), so the kernel adds them at absolute rows;
* ``FixPaddingBias`` and ``FixPaddingBias2d``: their residuals at absolute
  rows, the strip of the image's full height (or ``correction(H, W)``)
  sliced to the rank's rows;
* ``LowRankExpConvV1`` on ``lowrank_conv`` and ``QuantConv2d`` on one
  ``qmatmul`` (its im2col of the window): a conv's window of input rows
  ``[o0 s - p, (o1 - 1) s - p + k)``, zero rows at the true image edges, and
  one kernel call with padding ``(0, pw)``.  A strided 1x1 conv's window
  starts at an even global row, so it keeps the global rows' parity;
* ``MaxPool2d``: the conv's window, padded with ``-inf`` at the image edges.
  These three window forms take over their input's rows where the input
  owns its memory (:func:`_adopt`: the input becomes a view of the window's
  copy), so a rank does not hold its rows twice while the kernel runs;
* ``AdaptiveAvgPool2d``: ``(1, 1)`` is the heads' global mean
  (:func:`global_mean`: the sum over the owned rows, ``all_reduce``d over the
  model group, over the image's ``H W``, exact for uneven and empty shards);
  ``(oh, ow)`` gives rank ``i`` the output rows ``row_split(oh, n)[i]``, each
  the mean of its bin of global rows ``[floor(j H / oh), ceil((j + 1) H / oh))``,
  which may straddle a shard's edge; :func:`gather_rows` then gathers the
  small pooled map whole for a flattening head (VGG, AlexNet): the one map a
  rank gathers;
* the Ham head's pieces: :func:`resize_rows` (``resize_bilinear``: output row
  ``o`` of ``row_split(Hout, n)`` reads the input rows its half-pixel source
  index clamps to), ``GroupNorm`` over every rank's pixels (each rank's
  counts, means and squared deviations gathered and combined, as
  ``nn.GlobalBatchNorm`` does over ranks) and :func:`pixel_sums` (NMF's sums
  over all pixels ``X R^T`` and ``R R^T``, ``all_reduce``d before its ``eps``).

Every other layer of the models is pointwise in its rows (1x1 convs and their
matmul form, the norms, GELU, the residuals, layer scales) and runs on the
rank's rows as it is.

**Beside tensor parallelism.**  A model that ``parallel/tp.py::shard_module``
laid out over the same ``model`` axis may be laid out here too.  Ranks of
that axis hold different rows, so no Megatron pair's ``all_reduce`` (or a
column layer's ``all_gather``) may run inside a spatial forward: it would sum
partial products of different rows.  Inside one, every sharded parameter and
buffer is the whole tensor, gathered over the model axis once per change of
its shard and kept (it counts as allocated before the forward), and each
sharded layer runs its own forward or its row form on it; the shards stay
the parameters.

**The split.**  A map of ``H`` rows over ``n`` model ranks is split as XLA
pads a dimension: rank ``i`` holds rows ``[min(i c, H), min((i + 1) c, H))``
with ``c = ceil(H / n)``, so a map lower than the axis leaves the last ranks
with no rows (MSCAN's stage 4 at 48^2 over 3 ranks: 2 rows as 1, 1, 0).  Such
a rank computes nothing in that layer, and still sends its rows to the others
in the layers before.  The input must split evenly (:func:`shard_spatial`
raises as JAX's ``device_put`` does); the maps after a strided conv need not.

**The global height of a map.**  A rank's own rows do not determine the
image's (4 local rows are 7 or 8 over 2 ranks), so each halo layer learns its
input's layout, every rank's row count, with one ``all_gather`` over the
model group the first time it runs for an input layout, keyed by the layer's
name, its call's ordinal in the forward and the input's layout (which the
model's forward takes by one ``all_gather`` per forward); later forwards at
that size read the cache.  A layer called outside its model's spatial
forward learns its layout at every call.

**The exchange** (:func:`fetch_rows`) takes only the rows a rank needs from
the ranks that own them, however far (a halo taller than a neighbour's shard
reaches past it): every rank computes every rank's needs from the layout,
posts its receives, then its sends (``isend``/``irecv``, or one
``batch_isend_irecv`` on NCCL, so no rank blocks on a send), and assembles
its rows in an NHWC block (a ``channels_last`` NCHW map's own memory order,
so the kernels take the window with no layout copy).  On gloo a card's
message travels through a pinned host buffer, as ``parallel/pp.py`` does; a
bfloat16 message as its 16-bit pattern.  No rank all-gathers a map, but for
the small pooled map of a flattening head.

**What stays refused** (``MESH_TODO``): a forward in training mode or with
autograd on; a pipeline beside spatial sharding; ``deploy.compile_serving``
of a spatial model (a CUDA graph cannot capture gloo's host round trips); and
a layer with no row form (``AvgPool2d``, adaptive max pools, ``nn.Upsample``,
a pool in ``ceil_mode``, the QAT twins).  The JAX package lays out eval
forwards alone this way, so none of these is owed.
"""

from __future__ import annotations

import contextlib
import contextvars
import types
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.nn.modules.utils import _pair

from .distributed import MESH_TODO
from .mesh import DATA_AXIS, MODEL_AXIS, axis_ranks, batch_sharding, shard_rows
from .tp_layers import ModelAxis, all_gather_dim, install

__all__ = ["shard_spatial", "gather_spatial", "spatial_module", "unspatial_module", "is_spatial",
           "refuse_spatial", "row_split", "fetch_rows", "global_mean", "gather_rows",
           "global_size", "resize_rows", "pixel_sums", "window_fix", "stats"]

TAG = 24  # the exchange's messages; the q-th range a rank needs travels under TAG + q


# -- the split and the refusals -----------------------------------------------
def row_split(H: int, n: int) -> List[Tuple[int, int]]:
    """``[lo, hi)`` of each of ``n`` ranks over a map of ``H`` rows: ``ceil(H / n)``
    rows each, the last ranks short or empty."""
    c = -(-H // n) if H else 0
    return [(min(i * c, H), min((i + 1) * c, H)) for i in range(n)]


def refuse_spatial(what: str):
    """The ``NotImplementedError`` of what spatial sharding does not carry."""
    return NotImplementedError(f"{what}: {MESH_TODO}")


def _refused_layer(m: nn.Module) -> Optional[str]:
    """Why ``m`` has no row form, or None."""
    from convnet_approximater_tpu_torch.layers.quant import QATConv2d, QATLinear

    if isinstance(m, (nn.AvgPool2d, nn.AdaptiveMaxPool2d)):
        return "a pool with no row form"
    if isinstance(m, nn.MaxPool2d) and (m.ceil_mode or m.return_indices):
        return "a max pool in ceil_mode or returning indices"
    if isinstance(m, nn.AdaptiveAvgPool2d) and None in _pair(m.output_size):
        return "an adaptive pool that keeps a dim's size"
    if isinstance(m, nn.Upsample):
        return "a resize module"
    if isinstance(m, (QATConv2d, QATLinear)):
        return "a QAT twin, which trains"
    return None


def is_spatial(model: nn.Module) -> bool:
    """Whether :func:`spatial_module` laid ``model`` (or a module in it) out."""
    return any("_spatial" in m.__dict__ or "_spatial_plan" in m.__dict__
               for m in model.modules())


def _check_model(model: nn.Module) -> None:
    if is_spatial(model):
        raise ValueError("spatial_module: the model is spatially sharded already")
    if (any(getattr(m, "_pipeline", None) is not None for m in model.modules())
            or any(p.is_meta for p in model.parameters())):
        raise refuse_spatial("spatial sharding beside a pipeline (pipeline_parallel > 1)")
    for name, m in model.named_modules():
        why = _refused_layer(m)
        if why is not None:
            raise refuse_spatial(f"spatial sharding of {name or 'the model'} "
                                 f"({type(m).__name__}: {why}, which has no row form)")


def _check_eval(module: nn.Module) -> None:
    if module.training or torch.is_grad_enabled():
        raise refuse_spatial("spatial sharding in training mode or with autograd on (it "
                             "serves eval forwards under torch.no_grad())")


# -- the plan and the layouts ------------------------------------------------
class Rows(NamedTuple):
    """A map's layout: its global height and every rank's ``[lo, hi)``."""

    H: int
    bounds: Tuple[Tuple[int, int], ...]


class SpatialPlan:
    """A spatially sharded model's axis, layout cache and, beside tensor
    parallelism, its whole parameters by name (each with its shard's address
    and version); a copy of the model shares it."""

    def __init__(self, axis: ModelAxis):
        self.axis = axis
        self.cache: Dict[tuple, Rows] = {}
        self.whole: Dict[str, Tuple[tuple, torch.Tensor]] = {}

    def __deepcopy__(self, memo):
        return self


class SpatialLeaf(NamedTuple):
    """A layer's row-sharded form: its model's plan and its name there."""

    plan: SpatialPlan
    name: str

    def __deepcopy__(self, memo):
        return self


class _Forward:
    """One spatial forward of a model: its input's layout and address, and
    each layer's calls so far."""

    def __init__(self, plan: SpatialPlan, key: tuple, input_ptr: int = 0):
        self.plan, self.key, self.calls, self.input_ptr = plan, key, {}, input_ptr


_forward = contextvars.ContextVar("spatial_forward", default=None)


class Stats:
    """What the exchanges of this process have moved: messages and bytes sent,
    the bytes this rank put into the gathers of pooled maps
    (:func:`gather_rows`), and the copies the halo code made (the windows' and
    edges' assembly, the kept rows after a kernel).  :meth:`reset` sets them
    to 0."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.sent_messages = self.sent_bytes = self.gathered_bytes = self.copies = 0


stats = Stats()


def _backend(axis: ModelAxis) -> Optional[str]:
    return None if axis.group is None else dist.get_backend(axis.group)


def _row_counts(h: int, axis: ModelAxis, device) -> List[int]:
    """Every model rank's row count of a map of which this rank holds ``h`` rows."""
    if axis.size == 1:
        return [h]
    dev = device if _backend(axis) == "nccl" else torch.device("cpu")
    mine = torch.tensor([h], dtype=torch.int64, device=dev)
    parts = [torch.empty_like(mine) for _ in range(axis.size)]
    dist.all_gather(parts, mine, group=axis.group)
    return [int(t.item()) for t in parts]


def _rows_of(counts: Sequence[int]) -> Rows:
    bounds, lo = [], 0
    for c in counts:
        bounds.append((lo, lo + c))
        lo += c
    return Rows(lo, tuple(bounds))


def _layout(plan: SpatialPlan, name: str, x: torch.Tensor) -> Rows:
    """The layout of the map ``x`` (this rank's rows of it) that the layer or
    function ``name`` of ``plan``'s model takes: cached per input layout
    inside the model's spatial forward, learnt by an ``all_gather`` outside."""
    axis = plan.axis
    fwd = _forward.get()
    if fwd is None or fwd.plan is not plan:
        return _rows_of(_row_counts(x.shape[2], axis, x.device))
    ordinal = fwd.calls.get(name, 0)
    fwd.calls[name] = ordinal + 1
    key = (name, ordinal, fwd.key)
    rows = plan.cache.get(key)
    if rows is None:
        rows = plan.cache[key] = _rows_of(_row_counts(x.shape[2], axis, x.device))
    lo, hi = rows.bounds[axis.index]
    if hi - lo != x.shape[2]:
        raise RuntimeError(f"{name}: {x.shape[2]} rows where its cached layout gives this "
                           f"rank {hi - lo}")
    return rows


def input_rows(module: nn.Module, x: torch.Tensor) -> Rows:
    """The layout of ``module``'s input map ``x`` (this rank's rows of it)."""
    leaf: SpatialLeaf = module.__dict__["_spatial"]
    return _layout(leaf.plan, leaf.name, x)


# -- the exchange ------------------------------------------------------------
def _wire(t: torch.Tensor) -> torch.Tensor:
    """A dense message of ``t``: a bfloat16 tensor as its 16-bit pattern."""
    t = t.contiguous()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def fetch_rows(xh: torch.Tensor, rows: Rows, needs: Sequence[Sequence[Tuple[int, int]]],
               axis: ModelAxis, fill: float = 0.0) -> List[torch.Tensor]:
    """Rows of a map that the ranks hold in pieces: ``xh`` is this rank's
    rows as an NHWC tensor ``(B, h, W, C)`` (any strides), ``rows`` the map's
    layout, ``needs[j]`` the ranges ``[lo, hi)`` rank ``j`` asks for (every
    rank passes every rank's, the same).  Returns this rank's ranges, each a
    contiguous NHWC tensor, ``fill`` where a range passes the image's edge.
    Collective over the model group; only the rows a range takes from
    another rank travel."""
    me, H = axis.index, rows.H
    my_lo, my_hi = rows.bounds[me]
    B, _, W, C = xh.shape
    backend = _backend(axis)
    staged = xh.is_cuda and backend == "gloo"
    wire_type = torch.int16 if xh.dtype == torch.bfloat16 else xh.dtype

    def empty(n):
        return torch.empty((B, n, W, C), dtype=wire_type, device="cpu" if staged else xh.device,
                           pin_memory=staged)

    ops, recvs, plans = [], [], []
    for q, (lo, hi) in enumerate(needs[me]):
        parts = []
        if lo < min(hi, 0):
            parts.append(("zeros", min(hi, 0) - lo))
        for k, (a, b) in enumerate(rows.bounds):
            s, e = max(lo, a), min(hi, b)
            if s >= e:
                continue
            if k == me:
                parts.append(("own", xh[:, s - my_lo:e - my_lo]))
            else:
                buf = empty(e - s)
                ops.append(("recv", buf, axis.ranks[k], TAG + q))
                recvs.append(buf)
                parts.append(("recv", len(recvs) - 1))
        if max(lo, H) < hi:
            parts.append(("zeros", hi - max(lo, H)))
        plans.append(parts)
    for j in range(axis.size):
        if j == me:
            continue
        for q, (lo, hi) in enumerate(needs[j]):
            s, e = max(lo, my_lo), min(hi, my_hi)
            if s >= e:
                continue
            msg = _wire(xh[:, s - my_lo:e - my_lo])
            if staged:
                host = torch.empty(msg.shape, dtype=msg.dtype, pin_memory=True)
                host.copy_(msg)  # synchronous: the bytes are on the host before the send
                msg = host
            ops.append(("send", msg, axis.ranks[j], TAG + q))
            stats.sent_messages += 1
            stats.sent_bytes += msg.numel() * msg.element_size()
    works = _post(ops, axis, backend)
    for w in works:
        w.wait()
    got = []
    for buf in recvs:
        if buf.dtype != xh.dtype:
            buf = buf.view(xh.dtype)
        got.append(buf.to(xh.device) if staged else buf)
    out = []
    for parts in plans:
        tensors = []
        for kind, v in parts:
            if kind == "zeros":
                tensors.append(xh.new_full((B, v, W, C), fill))
            elif kind == "own":
                tensors.append(v)
            else:
                tensors.append(got[v])
        if len(tensors) == 1 and tensors[0].is_contiguous():
            out.append(tensors[0])
            continue
        stats.copies += 1
        out.append(torch.cat(tensors, dim=1) if len(tensors) > 1 else tensors[0].contiguous())
    return out


def _post(ops, axis: ModelAxis, backend: Optional[str]) -> list:
    """Start every receive, then every send: no rank blocks on a send.  NCCL
    takes them as one batch."""
    ops = sorted(ops, key=lambda o: o[0] != "recv")
    if not ops:
        return []
    if backend == "nccl":
        return dist.batch_isend_irecv([
            dist.P2POp(dist.irecv if kind == "recv" else dist.isend, t, peer, axis.group, tag)
            for kind, t, peer, tag in ops])
    return [(dist.irecv if kind == "recv" else dist.isend)(t, peer, group=axis.group, tag=tag)
            for kind, t, peer, tag in ops]


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(xh: torch.Tensor) -> torch.Tensor:
    return xh.permute(0, 3, 1, 2)


def _kept(y: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """Rows ``[start, start + n)`` of a kernel's NHWC output, as a dense
    ``channels_last`` NCHW map (the whole output where it is just those rows)."""
    if start == 0 and n == y.shape[1]:
        return _nchw(y)
    stats.copies += 1
    return _nchw(y[:, start:start + n].contiguous())


# -- the row-sharded forms ---------------------------------------------------
def _conv_geometry(conv: nn.Module) -> Tuple[int, int, int]:
    """(stride, padding, span) of the rows of a conv, ``QuantConv2d``,
    ``LowRankExpConvV1`` or ``MaxPool2d``."""
    padding = conv.padding
    if isinstance(padding, str) or getattr(conv, "padding_mode", "zeros") != "zeros":
        raise refuse_spatial(f"spatial sharding of a conv with padding {padding!r} "
                             f"({conv.padding_mode})")
    k, d = _pair(conv.kernel_size), _pair(getattr(conv, "dilation", 1))
    return _pair(conv.stride or conv.kernel_size)[0], _pair(padding)[0], d[0] * (k[0] - 1) + 1


def _edges_only(conv: nn.Conv2d, rows: Tuple[int, int], out: Tuple[int, int]) -> bool:
    """Whether a shard of input ``rows`` and output ``out`` runs the conv on
    its own rows and recomputes its edges: a stride-1 conv keeping the map's
    height and split, the shard at least twice its halo."""
    s, p, span = _conv_geometry(conv)
    return (s == 1 and span > 1 and 2 * p == span - 1 and rows == out
            and rows[1] - rows[0] >= 2 * (span - 1))


def _conv_needs(conv: nn.Conv2d, rows: Rows, out: Sequence[Tuple[int, int]]) -> list:
    """Every rank's ranges of the conv's input: the window of its output rows,
    or (:func:`_edges_only`) the windows of its top and bottom edge rows."""
    s, p, span = _conv_geometry(conv)
    needs = []
    for (lo, hi), (o0, o1) in zip(rows.bounds, out):
        if o1 <= o0:
            needs.append([])
        elif _edges_only(conv, (lo, hi), (o0, o1)):
            r = []
            if lo > 0:  # output rows [lo, lo + p) and the input rows they need
                r.append((lo - p, lo + span - 1))
            if hi < rows.H:  # output rows [hi - p, hi)
                r.append((hi - span + 1, hi + p))
            needs.append(r)
        else:
            needs.append([(o0 * s - p, (o1 - 1) * s - p + span)])
    return needs


def _conv(conv: nn.Conv2d, x: torch.Tensor, pad_rows: bool) -> torch.Tensor:
    pad = (conv.padding[0] if pad_rows else 0, conv.padding[1])
    return F.conv2d(x, conv.weight, conv.bias, conv.stride, pad, conv.dilation, conv.groups)


def _no_rows(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The layer's output on a rank that holds none of its rows."""
    k, s = _pair(conv.kernel_size), _pair(conv.stride or conv.kernel_size)
    p, d = _pair(conv.padding), _pair(getattr(conv, "dilation", 1))
    W_out = (x.shape[3] + 2 * p[1] - d[1] * (k[1] - 1) - 1) // s[1] + 1
    channels = getattr(conv, "out_channels", x.shape[1])  # a pool keeps its channels
    return x.new_zeros((x.shape[0], channels, 0, W_out)).contiguous(
        memory_format=torch.channels_last)


def pointwise_forward(self: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A conv whose rows are its input's (1 x k, stride 1 over the rows): the
    layer's own forward, or nothing on a rank with no rows."""
    return _no_rows(self, x) if x.shape[2] == 0 else type(self).forward(self, x)


def conv_split(conv: nn.Conv2d, rows: Rows, n: int) -> List[Tuple[int, int]]:
    """Every rank's output rows of the conv on a map laid out as ``rows``."""
    s, p, span = _conv_geometry(conv)
    return row_split((rows.H + 2 * p - span) // s + 1, n)


def conv_rows(conv: nn.Conv2d, x: torch.Tensor, got: List[torch.Tensor], rows: Rows,
              out: Sequence[Tuple[int, int]], index: int) -> torch.Tensor:
    """Rank ``index``'s output rows ``out[index]`` of the conv, from its own
    rows ``x`` and the ranges ``got`` that :func:`_conv_needs` asked for."""
    (lo, hi), (o0, o1) = rows.bounds[index], out[index]
    if o1 <= o0:
        return _no_rows(conv, x)
    if not _edges_only(conv, (lo, hi), (o0, o1)):
        return _conv(conv, _nchw(got[0]), False)
    p = conv.padding[0]
    y = _conv(conv, x, True)  # every row but the edges' is right
    q = 0
    if lo > 0:
        y[:, :, :p] = _conv(conv, _nchw(got[q]), False)
        q += 1
    if hi < rows.H:
        y[:, :, y.shape[2] - p:] = _conv(conv, _nchw(got[q]), False)
    return y


def conv_forward(self: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A ``Conv2d`` on this rank's rows (see the module docstring)."""
    _check_eval(self)
    axis = self.__dict__["_spatial"].plan.axis
    rows = input_rows(self, x)
    out = conv_split(self, rows, axis.size)
    got = fetch_rows(_nhwc(x), rows, _conv_needs(self, rows, out), axis)
    return conv_rows(self, x, got, rows, out, axis.index)


def fix_forward(self, x: torch.Tensor) -> torch.Tensor:
    """``FixPaddingBias`` at absolute rows: the image's strip, sliced to this rank's rows."""
    from convnet_approximater_tpu_torch.ops.msca_fused import fix_strip

    _check_eval(self)
    rows = input_rows(self, x)
    lo, hi = rows.bounds[self.__dict__["_spatial"].plan.axis.index]
    strip = fix_strip(self.res.transpose(1, 2), rows.H)[lo:hi]  # (h, C)
    return x + strip.t()[None, :, :, None]


def fix2d_forward(self, x: torch.Tensor) -> torch.Tensor:
    """``FixPaddingBias2d`` at absolute rows: ``correction(H, W)``'s rows of this rank."""
    _check_eval(self)
    rows = input_rows(self, x)
    lo, hi = rows.bounds[self.__dict__["_spatial"].plan.axis.index]
    m = self._cached_correction(rows.H, x.shape[3], (lo, hi))
    return x + m.permute(2, 0, 1)[None]


def _window_needs(rows: Rows, halo: int) -> list:
    """Every rank's window: its rows and ``halo`` rows each side, clipped to the image."""
    return [[(max(lo - halo, 0), min(hi + halo, rows.H))] if hi > lo else []
            for lo, hi in rows.bounds]


def window_fix(res: torch.Tensor, H: int, top: int, rows: int) -> torch.Tensor:
    """Border strips ``(2, p, C)`` that ``fix_strip`` places, on a window of
    ``rows`` rows starting at image row ``top``, as ``res`` places them on the
    image of ``H`` rows: the window's row ``i`` gets the image's row
    ``top + i`` (``fix_strip(window_fix(res, H, top, n), n) ==
    fix_strip(res, H)[top:top + n]``).  Every image row that ``fix_strip``
    touches lies within ``p`` rows of the window's top or bottom, so the
    top strip takes the window's first ``min(p, rows)`` rows and the bottom
    strip the rows below ``p`` that its last ``p`` rows reach."""
    from convnet_approximater_tpu_torch.ops.msca_fused import fix_strip

    p = res.shape[1]
    strip = fix_strip(res, H)[top:top + rows]  # (rows, C)
    out = res.new_zeros(res.shape)
    n = min(p, rows)
    out[0, :n] = strip[:n]
    j = max(0, 2 * p - rows)  # the bottom strip's slot j lands on window row rows - p + j >= p
    out[1, j:] = strip[rows - p + j:]
    return out


def _window_res(msca, args: dict, H: int, top: int, rows: int) -> Optional[torch.Tensor]:
    """:func:`window_fix` of the block's packed strips, one per window per weight version."""
    if args["fix_p"] == 0:
        return None
    cache = msca.__dict__.get("_spatial_res")
    if cache is None or cache[0] is not args:
        cache = msca.__dict__["_spatial_res"] = (args, {})
    key = (H, top, rows)
    if key not in cache[1]:
        cache[1][key] = window_fix(args["res"], H, top, rows)
    return cache[1][key]


def _window_forward(module, x: torch.Tensor, halo: int, run) -> torch.Tensor:
    """``run(window, H, top)`` on this rank's window of ``halo`` rows each side
    (the window starts at image row ``top`` of ``H``); its own rows kept."""
    axis = module.__dict__["_spatial"].plan.axis
    rows = input_rows(module, x)
    lo, hi = rows.bounds[axis.index]
    got = fetch_rows(_nhwc(x), rows, _window_needs(rows, halo), axis)
    if hi <= lo:
        return x
    window, top = got[0], max(lo - halo, 0)
    return _kept(run(window, rows.H, top), lo - top, hi - lo)


def msca_forward(self, x: torch.Tensor) -> torch.Tensor:
    """``MSCA``: one ``msca_fused`` call on this rank's window, the border
    fix remapped to the window (:func:`window_fix`); a block the kernel does
    not take runs its module path on its layers' row-sharded forms."""
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops

    _check_eval(self)
    if not self.can_fuse():
        return type(self).forward(self, x)
    args = self._kernel_weights()
    halo = max(args["ks"]) // 2 + self.conv0.kernel_size[0] // 2

    def run(window, H, top):
        kw = dict(args, res=_window_res(self, args, H, top, window.shape[1]))
        return fused_ops.msca_fused(window, **kw)

    return _window_forward(self, x, halo, run)


def bank_forward(self, x: torch.Tensor) -> torch.Tensor:
    """A strip bank: one ``parallel_cascade`` call on this rank's window of
    ``k_max // 2`` rows each side; a bank the kernel does not take runs its
    module path on its convs' row-sharded forms."""
    from convnet_approximater_tpu_torch.ops import parallel_cascade as cascade_ops

    _check_eval(self)
    packed = self.packed()
    if packed is None:
        return type(self).forward(self, x)
    return _window_forward(self, x, max(packed["ks"]) // 2,
                           lambda window, H, top: cascade_ops.parallel_cascade(window, **packed))


def _window(layer: nn.Module, x: torch.Tensor, fill: float = 0.0) -> Optional[torch.Tensor]:
    """This rank's window of the layer's input, the NHWC rows
    ``[o0 s - p, (o1 - 1) s - p + k)`` of its output rows ``[o0, o1)``, ``fill``
    outside the image; None on a rank with no output rows."""
    axis = layer.__dict__["_spatial"].plan.axis
    rows = input_rows(layer, x)
    s, p, span = _conv_geometry(layer)
    out = conv_split(layer, rows, axis.size)
    needs = [[(o0 * s - p, (o1 - 1) * s - p + span)] if o1 > o0 else [] for o0, o1 in out]
    got = fetch_rows(_nhwc(x), rows, needs, axis, fill)
    if not needs[axis.index]:
        return None
    top, bottom = needs[axis.index][0]
    lo, hi = rows.bounds[axis.index]
    if top <= lo and hi <= bottom:
        _adopt(x, got[0], lo - top)
    return got[0]


def _adopt(x: torch.Tensor, window: torch.Tensor, start: int) -> None:
    """Make the NCHW map ``x`` a view of rows ``[start, start + h)`` of the
    NHWC ``window`` that holds a copy of them, where ``x`` owns its memory:
    the rank then holds its rows once while a kernel reads the window and
    writes its output (VGG-16's first block holds its input, the window and
    the output at once).  The values stay; the model's input is left as it
    is."""
    fwd = _forward.get()
    if (fwd is None or x.data_ptr() == fwd.input_ptr or x.shape[2] == 0 or x._base is not None
            or not x.is_contiguous(memory_format=torch.channels_last)
            or x.untyped_storage().nbytes() != x.numel() * x.element_size()
            or window.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()):
        return
    rows = _nchw(window[:, start:start + x.shape[2]])
    x.set_(window.untyped_storage(), rows.storage_offset(), rows.shape, rows.stride())


def lowrank_forward(self, x: torch.Tensor) -> torch.Tensor:
    """``LowRankExpConvV1``: one ``lowrank_conv`` call on this rank's window,
    the rows' padding in the window; a layer the kernel does not take runs its
    module path on its convs' row forms."""
    from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops

    _check_eval(self)
    packed = self.packed() if self._may_fuse() else None
    if packed is None:
        return type(self).forward(self, x)
    window = _window(self, x)
    if window is None:
        return _no_rows(self, x)
    kw = dict(packed)
    return _nchw(lowrank_ops.lowrank_conv(
        window, kw.pop("A_mc"), kw.pop("b"), kernel_size=self.kernel_size, stride=self.stride,
        padding=(0, self.padding[1]), packed=kw.pop("kernel"), **kw))


def quant_forward(self, x: torch.Tensor) -> torch.Tensor:
    """``QuantConv2d``: one ``qmatmul`` over the im2col of this rank's window
    (the rows' padding in the window); a 1x1 stride-1 one on its own rows.
    The activation scale is static, so each output is the whole layer's."""
    _check_eval(self)
    if _conv_geometry(self) == (1, 0, 1):
        return pointwise_forward(self, x)
    window = _window(self, x)
    if window is None:
        return _no_rows(self, x)
    return self.conv(_nchw(window), (0, self.padding[1]))


def maxpool_forward(self, x: torch.Tensor) -> torch.Tensor:
    """``MaxPool2d`` on this rank's window, ``-inf`` outside the image as the
    pool's own padding."""
    _check_eval(self)
    window = _window(self, x, float("-inf"))
    if window is None:
        return _no_rows(self, x)
    return F.max_pool2d(_nchw(window), self.kernel_size, self.stride or self.kernel_size,
                        (0, _pair(self.padding)[1]), self.dilation)


def _bins(H: int, o: int, j: int) -> Tuple[int, int]:
    """Rows ``[floor(j H / o), ceil((j + 1) H / o))`` of adaptive pooling bin ``j``."""
    return j * H // o, -(-(j + 1) * H // o)


def adaptive_pool_forward(self, x: torch.Tensor) -> torch.Tensor:
    """``AdaptiveAvgPool2d``: to ``(1, 1)`` the image's mean
    (:func:`global_mean`, every model rank the whole); to ``(oh, ow)`` this
    rank's output rows of ``row_split(oh, n)``, each over its bin of global
    rows, fetched where a bin straddles a shard's edge."""
    _check_eval(self)
    oh, ow = _pair(self.output_size)
    if (oh, ow) == (1, 1):
        return global_mean(x)[:, :, None, None]
    axis = self.__dict__["_spatial"].plan.axis
    rows = input_rows(self, x)
    out = row_split(oh, axis.size)
    needs = [[(_bins(rows.H, oh, o0)[0], _bins(rows.H, oh, o1 - 1)[1])] if o1 > o0 else []
             for o0, o1 in out]
    got = fetch_rows(_nhwc(x), rows, needs, axis)
    o0, o1 = out[axis.index]
    if o1 <= o0:
        return x.new_zeros(x.shape[:2] + (0, ow)).contiguous(memory_format=torch.channels_last)
    window, top = _nchw(got[0]), needs[axis.index][0][0]
    return torch.cat([F.adaptive_avg_pool2d(window[:, :, a - top:b - top], (1, ow))
                      for a, b in (_bins(rows.H, oh, j) for j in range(o0, o1))], dim=2)


def _like(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y`` in ``x``'s type, ``channels_last`` where ``x``'s channels are innermost."""
    y = y.to(x.dtype)
    if x.dim() == 4 and x.stride(1) == 1:
        return y.contiguous(memory_format=torch.channels_last)
    return y


def group_moments(x: torch.Tensor, groups: int) -> torch.Tensor:
    """``(3, B, G)``: the count, mean and sum of squared deviations of each
    sample's group of channels over this rank's pixels of the NCHW map ``x``,
    in float32 (zeros on a rank with no pixels)."""
    xf = x.float().reshape(x.shape[0], groups, -1)
    n = xf.shape[2]
    if n:
        var, mean = torch.var_mean(xf, dim=2, correction=0)
    else:
        var = mean = xf.new_zeros(xf.shape[:2])
    return torch.stack([torch.full_like(mean, float(n)), mean, var * n])


def group_norm_rows(gn: nn.GroupNorm, x: torch.Tensor, parts: torch.Tensor) -> torch.Tensor:
    """``gn`` on this rank's rows ``x`` of a map, from every rank's
    :func:`group_moments` ``parts`` ``(ranks, 3, B, G)``, combined by Chan's
    update (as ``nn.GlobalBatchNorm`` combines ranks)."""
    counts, means, m2 = parts.unbind(1)
    total = counts.sum(0)
    mean = (counts * means).sum(0) / total
    m2 = (m2 + counts * (means - mean) ** 2).sum(0)
    xf = x.float().reshape(x.shape[0], gn.num_groups, -1)
    y = ((xf - mean[..., None]) * torch.rsqrt(m2 / total + gn.eps)[..., None]).reshape(x.shape)
    if gn.affine:
        y = y * gn.weight.float()[None, :, None, None] + gn.bias.float()[None, :, None, None]
    return _like(y, x)


def group_norm_forward(self, x: torch.Tensor) -> torch.Tensor:
    """``GroupNorm`` over every rank's pixels: each rank's moments
    (:func:`group_moments`) gathered over the model group and combined
    (:func:`group_norm_rows`)."""
    _check_eval(self)
    axis = self.__dict__["_spatial"].plan.axis
    if axis.size == 1:
        return type(self).forward(self, x)
    local = group_moments(x, self.num_groups)
    parts = [torch.empty_like(local) for _ in range(axis.size)]
    dist.all_gather(parts, local, group=axis.group)
    return group_norm_rows(self, x, torch.stack(parts))


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """``x.mean(dim=(2, 3))`` of an NCHW map; inside a spatial forward the
    mean over the whole image: the sums of the rank's rows and its row count,
    ``all_reduce``d over the model group, the sums over ``H W``."""
    fwd = _forward.get()
    if fwd is None:
        return x.mean(dim=(2, 3))
    axis = fwd.plan.axis
    s = x.sum(dim=(2, 3), dtype=torch.float32)
    if axis.size == 1:
        return (s / (x.shape[2] * x.shape[3])).to(x.dtype)
    buf = torch.cat([s.flatten(), s.new_tensor([float(x.shape[2])])])
    dist.all_reduce(buf, group=axis.group)
    H = int(round(float(buf[-1].item())))
    return (buf[:-1].view_as(s) / (H * x.shape[3])).to(x.dtype)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """``x``; inside a spatial forward, the whole of the small map whose rows
    this rank holds (a pooled map before a flattening head), gathered over the
    model group: the one map a rank gathers (:attr:`Stats.gathered_bytes`)."""
    fwd = _forward.get()
    if fwd is None or fwd.plan.axis.size == 1:
        return x
    axis = fwd.plan.axis
    rows = _layout(fwd.plan, "gather_rows", x)
    pad = x.new_zeros(x.shape[:2] + (max(hi - lo for lo, hi in rows.bounds),) + x.shape[3:])
    pad[:, :, :x.shape[2]] = x
    wire = _wire(pad)
    parts = [torch.empty_like(wire) for _ in range(axis.size)]
    dist.all_gather(parts, wire, group=axis.group)
    stats.gathered_bytes += wire.numel() * wire.element_size()
    return torch.cat([t.view(x.dtype)[:, :, :hi - lo] for t, (lo, hi) in zip(parts, rows.bounds)],
                     dim=2)


def global_size(x: torch.Tensor) -> Tuple[int, int]:
    """``x``'s map size (H, W); inside a spatial forward the whole image's
    height, of which this rank holds some rows (a resize's target)."""
    fwd = _forward.get()
    if fwd is None:
        return tuple(x.shape[2:])
    return _layout(fwd.plan, "global_size", x).H, x.shape[3]


def _source_rows(H_in: int, H_out: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The two input rows and the weight of the second for each output row of
    a half-pixel bilinear resize, in float32 as torch's resize takes them: the
    source index clamped at 0, the second row clamped to the last."""
    scale = np.float32(H_in) / np.float32(H_out)
    src = scale * (np.arange(H_out, dtype=np.float32) + np.float32(0.5)) - np.float32(0.5)
    src = np.maximum(src, np.float32(0))
    i0 = src.astype(np.int64)
    return i0, np.minimum(i0 + 1, H_in - 1), src - i0.astype(np.float32)


def resize_rows(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of an NCHW map to ``size``, half-pixel centres
    (``F.interpolate(..., align_corners=False)``); inside a spatial forward
    this rank's output rows of ``row_split(Hout, n)``, from the input rows
    their source indices read (clamped to the image's edge rows, as the
    resize clamps: no padding), fetched from their owners.  Each column is
    resized first, then each output row mixes its two input rows."""
    size = tuple(int(v) for v in size)
    fwd = _forward.get()
    if fwd is None:
        return F.interpolate(x, size=size, mode="bilinear", align_corners=False)
    axis = fwd.plan.axis
    rows = _layout(fwd.plan, "resize_rows", x)
    i0, i1, lam = _source_rows(rows.H, size[0])
    out = row_split(size[0], axis.size)
    needs = [[(int(i0[o0]), int(i1[o1 - 1]) + 1)] if o1 > o0 else [] for o0, o1 in out]
    got = fetch_rows(_nhwc(x), rows, needs, axis)
    o0, o1 = out[axis.index]
    if o1 <= o0:
        return x.new_zeros(x.shape[:2] + (0, size[1])).contiguous(
            memory_format=torch.channels_last)
    top = needs[axis.index][0][0]
    window = _nchw(got[0])
    wide = F.interpolate(window, size=(window.shape[2], size[1]), mode="bilinear",
                         align_corners=False)
    first = torch.as_tensor(i0[o0:o1] - top, device=x.device)
    second = torch.as_tensor(i1[o0:o1] - top, device=x.device)
    w1 = torch.as_tensor(lam[o0:o1], device=x.device).to(x.dtype)[None, None, :, None]
    w0 = torch.as_tensor(np.float32(1) - lam[o0:o1], device=x.device).to(x.dtype)[
        None, None, :, None]
    return wide.index_select(2, first) * w0 + wide.index_select(2, second) * w1


def pixel_sums(*ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The tensors ``ts``, each a sum over the pixels of this rank's rows;
    inside a spatial forward summed over the model group (one
    ``all_reduce``): the sums over every pixel of the image."""
    fwd = _forward.get()
    if fwd is None or fwd.plan.axis.size == 1:
        return ts
    flat = torch.cat([t.reshape(-1) for t in ts])
    dist.all_reduce(flat, group=fwd.plan.axis.group)
    return tuple(v.view_as(t) for v, t in zip(flat.split([t.numel() for t in ts]), ts))


@contextlib.contextmanager
def _whole_weights(model: nn.Module, plan: SpatialPlan):
    """Within the block every parameter and buffer that tensor parallelism
    sharded in ``model`` is the whole tensor, gathered over the model axis
    once per change of its shard (kept in ``plan.whole``), and every sharded
    layer is marked whole (``whole_weights`` gathers nothing more).
    Collective over the model group where a shard changed; a no-op without
    tensor parallelism."""
    from .tp import tp_plan

    tplan = tp_plan(model)
    if tplan is None:
        yield
        return
    swaps: Dict[nn.Module, list] = {}
    for name, d in tplan.dims.items():
        leaf, _, n = name.rpartition(".")
        m = model.get_submodule(leaf)
        store = m._parameters if n in m._parameters else m._buffers
        t = store[n]
        key = (t.data_ptr(), t._version, t.device)
        hit = plan.whole.get(name)
        if hit is None or hit[0] != key:
            whole = all_gather_dim(t.detach(), d, tplan.axis)
            if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
                whole = whole.contiguous(memory_format=torch.channels_last)
            hit = plan.whole[name] = (key, whole)
        swaps.setdefault(m, []).append((store, n, t, hit[1]))
    marked = [m for m in model.modules() if "_tp" in m.__dict__]
    for entries in swaps.values():
        for store, n, _, whole in entries:
            store[n] = whole
    for m in marked:
        m.__dict__["_tp_whole"] = True
    try:
        yield
    finally:
        for entries in swaps.values():
            for store, n, shard, _ in entries:
                store[n] = shard
        for m in marked:
            m.__dict__.pop("_tp_whole", None)


def model_forward(self, *args, **kwargs):
    """The model's forward over its rows: eval mode without autograd, each
    layer's layout cached per input layout."""
    _check_eval(self)
    plan: SpatialPlan = self.__dict__["_spatial_plan"]
    x = args[0]
    key = (tuple(_row_counts(x.shape[2], plan.axis, x.device)), tuple(x.shape[3:]))
    token = _forward.set(_Forward(plan, key, x.data_ptr()))
    try:
        with _whole_weights(self, plan):
            return type(self).forward(self, *args, **kwargs)
    finally:
        _forward.reset(token)


def plain_forward(self, *args, **kwargs):
    """A layer that tensor parallelism sharded, inside a spatial forward: its
    own forward, on the whole weights."""
    return type(self).forward(self, *args, **kwargs)


def _form(m: nn.Module):
    """The row-sharded forward of ``m``, or None where it runs on its rows as it is."""
    from convnet_approximater_tpu_torch.layers import MSCA, FixPaddingBias, FixPaddingBias2d
    from convnet_approximater_tpu_torch.layers.depth_separable_conv import _StripBank
    from convnet_approximater_tpu_torch.layers.low_rank_conv import LowRankExpConvV1
    from convnet_approximater_tpu_torch.layers.quant import QuantConv2d

    forms = ((MSCA, msca_forward), (_StripBank, bank_forward), (FixPaddingBias, fix_forward),
             (FixPaddingBias2d, fix2d_forward), (LowRankExpConvV1, lowrank_forward),
             (QuantConv2d, quant_forward), (nn.MaxPool2d, maxpool_forward),
             (nn.AdaptiveAvgPool2d, adaptive_pool_forward), (nn.GroupNorm, group_norm_forward))
    for cls, form in forms:
        if isinstance(m, cls):
            return form
    if isinstance(m, nn.Conv2d):
        s, p, span = _conv_geometry(m)
        return pointwise_forward if (s, p, span) == (1, 0, 1) else conv_forward
    if "_tp" in m.__dict__:  # a sharded layer of no other form: its own forward, whole
        return plain_forward
    return None


# -- the model ---------------------------------------------------------------
def _model_axis(mesh) -> ModelAxis:
    if mesh is None:
        return ModelAxis(0, 1, None, (0,))
    index, size, group, ranks = axis_ranks(mesh, MODEL_AXIS)
    return ModelAxis(index, size, group, tuple(ranks))


def spatial_module(model: nn.Module, mesh) -> nn.Module:
    """Lay ``model`` (eval mode, its weights replicated on every rank) out
    for ``mesh.spatial_sharding``, in place: every spatial layer takes its
    row-sharded form and the model's forward takes this rank's block of a
    batch (:func:`shard_spatial`) to its rows' logits, every model rank
    returning its data rows' logits whole.  ``mesh`` None is one process
    holding every row.  A model that ``tp.shard_module`` sharded over the
    same model axis keeps its shards; its spatial forward runs on the whole
    weights.  Raises ``NotImplementedError`` for what stays refused
    (``MESH_TODO``): a pipelined model, a layer with no row form; a forward in
    training mode or with autograd on raises there."""
    from .tp import tp_plan

    _check_model(model)
    plan = SpatialPlan(_model_axis(mesh))
    tplan = tp_plan(model)
    if tplan is not None and tuple(tplan.axis.ranks) != plan.axis.ranks:
        raise ValueError(f"spatial_module: the model is tensor-parallel over ranks "
                         f"{tplan.axis.ranks}, the mesh's model axis is {plan.axis.ranks}")
    for name, m in model.named_modules():
        form = _form(m)
        if form is not None:
            m.__dict__["_spatial"] = SpatialLeaf(plan, name)
            m.__dict__["forward"] = types.MethodType(form, m)
    model.__dict__["_spatial_plan"] = plan
    model.__dict__["forward"] = types.MethodType(model_forward, model)
    return model


def unspatial_module(model: nn.Module) -> nn.Module:
    """Give every layer of ``model`` its own forward again, or its
    tensor-parallel form (no collective)."""
    for m in model.modules():
        m.__dict__.pop("_spatial_res", None)
        leaf = m.__dict__.pop("_spatial", None)
        plan = m.__dict__.pop("_spatial_plan", None)
        if leaf is not None or plan is not None:
            m.__dict__.pop("forward", None)
            if "_tp" in m.__dict__:
                install(m, m.__dict__["_tp"])
    return model


# -- the batch ---------------------------------------------------------------
def shard_spatial(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of the NCHW batch ``x``: its data rank's rows of the
    batch (as ``shard_batch``) and its model rank's image rows, a dense
    ``channels_last`` copy.  The model axis must divide the image's rows, as
    JAX's ``device_put`` of a ``spatial_sharding`` requires."""
    axis = _model_axis(mesh)
    H = x.shape[2]
    if H % axis.size:
        raise ValueError(f"shard_spatial: an image of {H} rows over a model axis of "
                         f"{axis.size}, which implies that the global size of its dimension 1 "
                         f"(the NHWC rows) should be divisible by {axis.size}, but it is equal "
                         f"to {H}")
    if mesh is not None:
        x = x[shard_rows(x.shape[0], batch_sharding(mesh))]
    lo, hi = row_split(H, axis.size)[axis.index]
    return x[:, :, lo:hi].contiguous(memory_format=torch.channels_last)


def gather_spatial(y: torch.Tensor, mesh) -> torch.Tensor:
    """The whole NCHW map (or logits) from every rank's block of it: the
    model ranks' rows (a map's; logits are whole on every model rank), then
    the data ranks' batches.  Collective; for checking a result, not inside a
    forward."""
    if mesh is None:
        return y
    axis = _model_axis(mesh)
    if y.dim() == 4 and axis.size > 1:
        counts = _row_counts(y.shape[2], axis, y.device)
        top = max(counts)
        dense = y.contiguous()
        pad = dense.new_zeros(y.shape[:2] + (top,) + y.shape[3:])
        pad[:, :, :y.shape[2]] = dense
        parts = [torch.empty_like(pad) for _ in range(axis.size)]
        dist.all_gather(parts, pad, group=axis.group)
        y = torch.cat([t[:, :, :c] for t, c in zip(parts, counts)], dim=2)
    index, count, group, _ = axis_ranks(mesh, DATA_AXIS)
    if count > 1:
        parts = [torch.empty_like(y.contiguous()) for _ in range(count)]
        dist.all_gather(parts, y.contiguous(), group=group)
        y = torch.cat(parts)
    return y
