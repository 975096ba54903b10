"""Tensor parallelism of the RNA encoder over a mesh's ``mp`` group.

Counterpart of ``multimodalbrainsurvival_tpu/parallel/sharding.py:34-62``
(``joint_param_shardings``): the RNA encoder's hidden axis is sharded as
Megatron column / row pairs at any depth, everything else replicated:

- even ``dense_i`` (the ``i``-th Linear of ``rna_mlp``) is column-parallel:
  its output rows (``weight`` dim 0, the JAX kernel's ``P(None, 'mp')``)
  split over ``mp``, and so its bias, which the port adds to the rank's
  output columns;
- odd ``dense_i`` is row-parallel: its input columns (``weight`` dim 1,
  ``P('mp', None)``) split; its partial products are all-reduced over
  ``mp`` before the (replicated) bias;
- an odd depth ends column-parallel, and the last activation is
  all-gathered (JAX ``sharding.py:42-45``).

As in the JAX package no CLI applies it (the CLIs replicate the
parameters and use ``mp`` for the bag): ``shard_model`` shards an
``RNAOnlyModel`` or a joint model's encoder in place, for the dry run
(``parallel/dryrun.py``) and the tests; ``gathered_state_dict`` puts the
shards back together into a whole ``state_dict`` in reference layout.
``models/rna.py::dropout_linears`` runs a sharded encoder: K2a on the
local shard, with ``col0 = mp_rank · H / mp`` for a row-parallel layer's
mask, so every rank draws the columns of the unsharded mask it holds.
"""

from __future__ import annotations

from torch import nn

from multimodalbrainsurvival_torch.parallel.mesh import Mesh, all_gather

#: the encoders' names in the port's models (RNAOnlyModel, the joint models)
ENCODER = "rna_mlp"


def joint_param_shardings(model: nn.Module) -> dict[str, int | None]:
    """Every parameter name → the dim of it that is split over ``mp``, or
    None (replicated): the JAX rule over the port's names, at any depth."""
    plan: dict[str, int | None] = {name: None for name, _ in model.named_parameters()}
    encoder = getattr(model, ENCODER, None)
    if encoder is None:
        return plan
    linears = [name for name, m in encoder.named_children() if isinstance(m, nn.Linear)]
    for i, child in enumerate(linears):
        column = i % 2 == 0
        plan[f"{ENCODER}.{child}.weight"] = 0 if column else 1
        plan[f"{ENCODER}.{child}.bias"] = 0 if column else None
    return plan


def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Shard ``model``'s RNA encoder over ``mesh.mp`` by ``joint_param_shardings``, in
    place: each split parameter becomes this rank's contiguous slice. The
    encoder then runs tensor-parallel (``encoder.tp = mesh``)."""
    if mesh.mp == 1:
        return model
    encoder = getattr(model, ENCODER)
    for name, dim in joint_param_shardings(model).items():
        if dim is None:
            continue
        module, attr = _owner(model, name)
        full = getattr(module, attr)
        if full.shape[dim] % mesh.mp:
            raise ValueError(f"{name}: {full.shape[dim]} does not split over mp={mesh.mp}")
        n = full.shape[dim] // mesh.mp
        shard = full.detach().narrow(dim, mesh.mp_rank * n, n).clone()
        setattr(module, attr, nn.Parameter(shard, requires_grad=full.requires_grad))
    encoder.tp = mesh
    return model


def gathered_state_dict(model: nn.Module) -> dict:
    """``model``'s ``state_dict`` with a sharded encoder's slices gathered
    over ``mp`` (every rank of the group must call): the reference layout,
    as the unsharded model's."""
    state = {k: v.detach() for k, v in model.state_dict().items()}
    mesh = getattr(getattr(model, ENCODER, None), "tp", None)
    if mesh is None:
        return state
    for name, dim in joint_param_shardings(model).items():
        if dim is not None:
            state[name] = all_gather(state[name], mesh.mp_group, dim)
    return state


def _owner(model: nn.Module, name: str) -> tuple[nn.Module, str]:
    path, attr = name.rsplit(".", 1)
    return model.get_submodule(path), attr
