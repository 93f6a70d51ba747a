"""Device-mesh sharding for batched and multi-stream serving.

Counterpart of `pocket_tts_tpu/parallel/sharding.py`: a ("data", "model")
mesh where concurrent streams (lanes) shard over "data" and the
transformers' heads and MLP widths shard over "model" (tensor parallel).
The JAX package lays the arrays out with NamedShardings and lets GSPMD
insert the collectives. Here every rank is a process of its own
(parallel/launch.py) holding only its block, and the model code calls the
collectives itself (models/backbone.py, models/mimi_transformer.py):

- one all-reduce (sum) over "model" after each row-parallel product
  (a float `out_proj` or `linear2`), before its residual add
  (`row_linear`);
- one all-gather over "model" of the input of a quantized `out_proj` or
  `linear2`, which every rank holds whole: the rank's column block of the
  input, gathered in rank order, is the whole input, and the whole
  product runs on it (`row_linear`);
- one all-reduce (max) over "model" of each new K/V row's absmax before
  an int8 cache quantizes it, so that every head shard scales its columns
  by the WHOLE row's absmax, as the JAX package computes the scales over
  the full row and hands them replicated to the head shards
  (`reduce_absmax`);
- one all-gather over "data" where the host reads the audio (`gather_lanes`).

Each collective takes tensors on the mesh's device: CUDA tensors over
NCCL with one rank a card, CPU or CUDA tensors over gloo
(parallel/launch.py). Every rank of a group receives the same reduced
bits from either backend, which keeps the ranks of a "model" group equal
bit for bit: the EOS reads and the admissions run on every rank with no
broadcast.

Layout rules (`_spec_for_param`, `_spec_for_state`), the JAX package's:

- `in_proj` and `linear1` are column-parallel, float or quantized (the
  `q` / `q4` / `scale` leaves, a q4_0 (L, K/32, N) scale too, split on
  their output axis like `w` and `b`).
- A float `out_proj` or `linear2` is row-parallel: its weight, kept in
  float32, split on the input axis, a bias added once, after the sum. A
  quantized one stays WHOLE on every rank (the JAX package splits only
  `['w']` by rows), and its input is gathered first: the layout GSPMD
  gives a replicated weight after head-sharded activations. It also
  keeps the ranks of a "model" group bit-equal, which the EOS reads rely
  on. Everything else is whole on every rank too: the flow net, the
  SEANet, norms, `layer_scale`, gating MLPs, cross-attention.
- The column split of `in_proj` FOLLOWS THE HEADS: its output is q | k | v,
  and rank r takes its heads' columns of each third (`Shard.groups` = 3).
  JAX splits the fused 3·d dim into contiguous blocks and lets GSPMD
  reshard; a plain contiguous split here would give rank 0 all of q and
  half of k. The rope permutation of the loader is per head
  (io/params.py), so it holds inside each head block.
- A transformer whose head count "model" does not divide (mesh_cfg pins
  it to the plain route) keeps all of its params and state whole.
- State: every lane-carrying tensor takes the rank's contiguous block of
  B / data lanes; the flat caches (B, S, H*D) also the rank's heads'
  columns; the shared-prefix tables `pk` / `pv` (H, P, D) are whole over
  "data" and head-sliced over "model" when H % model == 0; the host
  cursors (`end`, `ring_start`, the mimi ring `offset`) are the same on
  every rank.

`shard_params` and `shard_batched_state` return THIS rank's block of a
whole tree or state (the JAX functions return the global array with its
layout); `param_shardings` and `batched_state_shardings` return the
`Shard` of every leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

MESH_DIMS = ("data", "model")

# collectives issued by this module (all-reduces; all-gathers) since the
# last reset: chip_smoke.py reads them per decode step
collectives = {"all_reduce": 0, "all_gather": 0}


def make_mesh(data: Optional[int] = None, model: int = 1,
              device_type: str = "cuda"):
    """The ("data", "model") DeviceMesh over the initialized process
    group's ranks: rank r sits at (r // model, r % model), so the ranks of
    one "model" group are consecutive. data defaults to world // model."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialize the process group first "
                           "(parallel.launch spawns initialized ranks)")
    n = dist.get_world_size()
    if data is None:
        data = n // model
    assert data * model == n, f"{data}x{model} != {n} ranks"
    return DeviceMesh(device_type,
                      torch.arange(n, dtype=torch.int64).reshape(data, model),
                      mesh_dim_names=MESH_DIMS)


def _check_dims(mesh) -> None:
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if not set(MESH_DIMS) <= set(names):
        raise ValueError(f"a mesh needs the dims {MESH_DIMS}, got {names} "
                         "(build it with parallel.sharding.make_mesh)")


def axis_size(mesh, name: str) -> int:
    """The mesh's size along "data" or "model" (1 without a mesh)."""
    if mesh is None:
        return 1
    _check_dims(mesh)
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def axis_rank(mesh, name: str) -> int:
    """This rank's coordinate along "data" or "model" (0 without a
    mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(name)


def model_group(part_cfg):
    """The "model" process group a sharded transformer part reduces over,
    or None (no mesh on the part, or "model" of size 1)."""
    mesh = part_cfg.mesh
    if mesh is None or axis_size(mesh, "model") == 1:
        return None
    return mesh.get_group("model")


def fusable(p, mesh) -> bool:
    """Whether a transformer layer's params p take the fused layer kernels
    (K5a / K5b, and K5c / K8 where the cfg asks): `fused_layer.supported`
    takes them and the layer runs without a mesh, as the JAX package gates
    them (`mesh is None`). On a mesh a rank holds its heads' columns of
    in_proj and its block of linear1 beside a whole quantized out_proj /
    linear2: K5a would run on the shard, and K5b's out_proj -> LN2 -> MLP
    tail would skip the gather (`row_linear`)."""
    from ..ops.fused_layer import supported
    return mesh is None and supported(p)


def local_heads(part_cfg) -> int:
    """The heads this rank holds of a transformer part (its cfg's
    `num_heads` over "model" when the part carries the mesh)."""
    return part_cfg.num_heads // axis_size(part_cfg.mesh, "model")


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def reduce_absmax(rows, group):
    """(..., W) rows -> (...,) float32 absmax of each whole row: the local
    columns' absmax, maxed over the group (rows may stack several caches'
    rows, one reduce for all)."""
    amax = rows.float().abs().amax(-1)
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        collectives["all_reduce"] += 1
    return amax


def row_linear(p, x, group):
    """The product of an `out_proj` or `linear2` whose input x holds this
    rank's block of the features. A float weight is row-parallel: p holds
    its rows, which shard_params keeps in float32; the partial product is
    taken in float32 and summed over the group in float32 with the (whole)
    bias, then rounded once to x's dtype, as the whole product rounds
    once. With bf16 weights and activations this is the unsharded
    product's precision: products of bf16 values are exact in float32
    (and in TF32), and both accumulate in float32. A quantized weight
    (`q` / `q4` + `scale`) is whole: x is gathered over the group
    (`gather_columns`) and the whole product (K4a / K4b on the card) runs
    on it, the bias added as the unsharded product adds it, no sum.
    Without a group it is ops.basic.linear."""
    from ..ops.basic import linear
    if group is None:
        return linear(p, x)
    if "w" not in p:
        return linear(p, gather_columns(x, group))
    y = linear({"w": p["w"]}, x.float())
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    collectives["all_reduce"] += 1
    return (y if p.get("b") is None else y + p["b"].float()).to(x.dtype)


def gather_columns(x, group):
    """The whole feature axis of x (..., W / model): each rank's column
    block, gathered over the "model" group in rank order, which is the
    unsharded order (in_proj splits by heads, linear1 contiguously)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    collectives["all_gather"] += 1
    return torch.cat(parts, -1)


def gather_lanes(t, mesh):
    """The whole lane axis of a (B / data, ...) tensor: each "data" rank's
    block, gathered where it lives, in data order, then copied to the host
    (a CPU tensor)."""
    n = axis_size(mesh, "data")
    if n == 1:
        return t.detach().cpu()
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=mesh.get_group("data"))
    collectives["all_gather"] += 1
    return torch.cat(parts, 0).cpu()


def max_over_data(value: int, mesh) -> int:
    """An int that every rank must agree on, maxed over "data" (reduced on
    the mesh's device type, as every collective here)."""
    if axis_size(mesh, "data") == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=mesh.device_type)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.get_group("data"))
    collectives["all_reduce"] += 1
    return int(t[0])


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Shard:
    """The layout of one leaf: `lanes` splits axis 0 over "data" into
    contiguous blocks; `dim` is the axis split over "model", cut into
    `groups` equal parts that are split each (3 for in_proj's q | k | v);
    `float32` keeps the rank's block in float32 (the row-parallel weights,
    cast once here rather than at every product, see row_linear).
    Shard() is whole on every rank."""
    lanes: bool = False
    dim: Optional[int] = None
    groups: int = 1
    float32: bool = False


WHOLE = Shard()


def _spec_for_param(path: str, ndim: int) -> Shard:
    """Tensor-parallel layout of a leaf of a transformer's stacked layers:
    in_proj (by heads) and linear1 column-parallel, float or quantized;
    float out_proj / linear2 weights row-parallel; everything else whole,
    the quantized out_proj / linear2 leaves included."""
    if "cross_attention" in path or "gating" in path:
        return WHOLE
    if "in_proj" in path:
        return Shard(dim=ndim - 1, groups=3)
    if "linear1" in path:
        return Shard(dim=ndim - 1)
    if "out_proj" in path or "linear2" in path:
        return (Shard(dim=ndim - 2, float32=True) if path.endswith("/w")
                else WHOLE)
    return WHOLE


def _tree_map(fn, tree, path=""):
    """fn(path, leaf) over the tensors of nested dicts, lists and
    dataclasses; other leaves (host ints, None) go through fn too."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name), f"{path}.{f.name}")
            for f in dataclasses.fields(tree)})
    return fn(path, tree)


def _transformers(cfg):
    """(params path prefix, cfg part) of the two tensor-parallel parts."""
    return (("/layers/", cfg.backbone),
            ("/mimi/decoder_transformer/layers/", cfg.mimi.transformer))


def _param_spec(mesh, cfg):
    """fn(path, leaf) -> the leaf's Shard (see param_shardings)."""
    reduces = axis_size(mesh, "model") > 1
    split = [pre for pre, part in _transformers(cfg)
             if part.mesh is not None]

    def spec(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return WHOLE
        if not any(path.startswith(pre) for pre in split):
            return WHOLE
        s = _spec_for_param(path, leaf.dim())
        # without a "model" reduce row_linear is ops.basic.linear, which
        # takes the weight in the working dtype
        return s if reduces else dataclasses.replace(s, float32=False)

    return spec


def param_shardings(params, mesh, cfg):
    """The Shard of every leaf of `params` under `mesh`. cfg: the model
    cfg built through runtime.batched.mesh_cfg; a transformer part that
    carries no mesh there (its heads do not divide "model") stays whole."""
    return _tree_map(_param_spec(mesh, cfg), params)


def _block(t, spec: Shard, mesh):
    if spec.lanes:
        n = axis_size(mesh, "data")
        if t.shape[0] % n:
            raise ValueError(f"{t.shape[0]} lanes do not split over data "
                             f"{n}")
        c = t.shape[0] // n
        t = t.narrow(0, axis_rank(mesh, "data") * c, c)
    if spec.dim is not None:
        m = axis_size(mesh, "model")
        size = t.shape[spec.dim]
        if size % (spec.groups * m):
            raise ValueError(f"axis of {size} does not split into "
                             f"{spec.groups} x {m} blocks")
        g = size // spec.groups
        c = g // m
        r = axis_rank(mesh, "model")
        t = torch.cat([t.narrow(spec.dim, j * g + r * c, c)
                       for j in range(spec.groups)], spec.dim)
    if spec.float32:
        t = t.float()
    return t.contiguous() if (spec.lanes or spec.dim is not None) else t


def shard_params(params, mesh, cfg):
    """This rank's block of a whole params tree (copies of the split
    leaves; whole leaves are shared), float or quantized."""
    spec = _param_spec(mesh, cfg)
    return _tree_map(lambda path, leaf: (
        _block(leaf, spec(path, leaf), mesh)
        if isinstance(leaf, torch.Tensor) else leaf), params)


def _spec_for_state(path: str, shape, model: int, split_backbone: bool,
                    split_mimi: bool) -> Shard:
    """Layout of a lane-axis state leaf (paths as `flow.k[0]`)."""
    if shape is None or len(shape) == 0:
        return WHOLE
    if ".pk[" in path or ".pv[" in path:
        # shared-prefix tables: head-major (H, P, D), one copy for all the
        # lanes: whole over "data", head-sliced over "model" when H divides
        return Shard(dim=0) if split_backbone and shape[0] % model == 0 \
            else WHOLE
    if len(shape) >= 3 and (".k[" in path or ".v[" in path):
        split = split_mimi if path.startswith("mimi.") else split_backbone
        return Shard(lanes=True, dim=2 if split else None)
    return Shard(lanes=True)


def _state_spec(state, mesh, cfg):
    """fn(path, leaf) -> the leaf's Shard (see batched_state_shardings)."""
    model = axis_size(mesh, "model")
    sb, sm = cfg.backbone.mesh is not None, cfg.mimi.transformer.mesh \
        is not None
    # a lone backbone state's fields are named as in a stream state's flow
    prefix = "" if hasattr(state, "mimi") else "flow."

    def spec(path, leaf):
        shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else None
        return _spec_for_state(prefix + path[1:], shape, model, sb, sm)

    return spec


def batched_state_shardings(state, mesh, cfg):
    """The Shard of every leaf of a lane-axis state (a
    tts.BatchedStreamState or a backbone.BatchedBackboneState)."""
    return _tree_map(_state_spec(state, mesh, cfg), state)


def shard_batched_state(state, mesh, cfg):
    """This rank's block of a whole lane-axis state: its B / data lanes,
    and its heads' columns of the caches of the parts cfg splits (copies;
    the host cursors are kept)."""
    spec = _state_spec(state, mesh, cfg)
    return _tree_map(lambda path, leaf: (
        _block(leaf, spec(path, leaf), mesh)
        if isinstance(leaf, torch.Tensor) else leaf), state)
