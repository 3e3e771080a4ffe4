"""The shared SO-Net encoder (port of the JAX package's ``nn/encoder.py``).

Pipeline (channel-last): top-k point->node assignment, k-stacked points,
cluster-mean node recentering (together the point-to-node grouping, the
profiler range ``sonet:grouping``), decentered PointResNet over kN
points, segment-max node pooling, kNN aggregation over nodes, final
PointNet, global max over nodes with first-winner gradient routing.
Train or eval follows ``nn.Module.training``; ``epoch`` drives the
BatchNorm momentum decay in training.

With ``pooling="sorted_window"`` the stacked points are sorted by node
once per forward (on a card, by the counting-sort kernel
``ops.cuda.sorts.node_sort``): the node counts and cluster sums run through the CUDA
segment-sum kernel over each node's run of rows (``ops.cuda.segment_sums``)
and pooling through the CUDA windowed segment-max kernel
(``ops.segment_fast``); every per-point layer is permutation-equivariant
and the cluster means are order-invariant, so only pooling sees the
order.

Under a mesh (``parallel.collectives.use_mesh``) each rank holds its
(B/D, N/P) block of the cloud: it stacks the k copies of its own points
and sorts them locally (segment max does not care about the order); the
node counts and the cluster sums are summed over ``points``, pooling is
combined over ``points`` (``ops.segment_fast``), and everything from the
pooled nodes on -- kNN, the kNN layer, the final PointNet, the global
max -- is node-level work, the same on every points rank.  The first
PointNet's BatchNorms reduce over the whole mesh (``sharded_points``).

With ``cfg.remat`` a training forward keeps none of the first PointNet's
(B, kN, 64..384) activations, the step's largest: the backward runs that
stack again (``torch.utils.checkpoint``), as the JAX package's
``nn.remat`` does.  ``Transformer`` and ``rotation_matrix_y`` are the
reference's rotation regressor, dead there too; they are here for the
API's sake.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import Config
from ..ops import (assign_topk, knn, one_hot, segment_max, segment_max_fast,
                   segment_sums)
from ..ops.cuda.sorts import NODE_SORT_MAX_NODES, node_sort, node_sort_plain
from ..parallel import collectives
from ..utils.spans import span
from .layers import (KNNModule, PointLayer, PointNetMLP, PointResNet,
                     recomputation)

GROUPING = "sonet:grouping"


def resolve_pooling(cfg: Config, device: torch.device | str) -> str:
    """``cfg.pooling`` for a model on ``device``: "auto" is the sorted
    pipeline with the CUDA kernel on a CUDA device and the scatter form
    on the CPU (pin ``pooling="sorted_window"`` to run the sorted pipeline
    there, through the kernel's plain version)."""
    if cfg.pooling not in ("auto", "scatter", "sorted_window"):
        raise ValueError(f"pooling={cfg.pooling!r}")
    if cfg.pooling != "auto":
        return cfg.pooling
    return ("sorted_window" if torch.device(device).type == "cuda"
            else "scatter")


def spatial_dim(cfg: Config) -> int:
    return 2 if cfg.dataset == "mnist" else 3


def compute_dtype(cfg: Config) -> Optional[torch.dtype]:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


def layer_kw(cfg: Config) -> dict:
    """The compute dtype and BatchNorm momentum options of every layer."""
    return dict(compute_dtype=compute_dtype(cfg), momentum=cfg.bn_momentum,
                bn_momentum_decay_step=cfg.bn_momentum_decay_step,
                bn_momentum_decay=cfg.bn_momentum_decay)


class EncoderOutput(NamedTuple):
    """What the encoder hands to the heads.  With the sorted pipeline
    (``perm is not None``) every per-point tensor -- min_idx, centers,
    x_stack, sn_stack, x_decentered, first_pn_out, onehot -- is in
    node-sorted order; ``inv_perm`` maps back
    (original[j] = sorted[inv_perm[j]]).  The segmenter un-permutes once,
    before it averages the k copies."""

    feature: torch.Tensor              # (B, F) global shape feature
    min_idx: torch.Tensor              # (B, kN) int32 node id per point
    mask_row_max: torch.Tensor         # (B, M) bool node occupancy
    counts: torch.Tensor               # (B, M) f32 points per node
    som_node: torch.Tensor             # (B, M, D) cluster-mean nodes
    centers: torch.Tensor              # (B, kN, D) per-point node center
    x_stack: torch.Tensor              # (B, kN, D)
    sn_stack: torch.Tensor             # (B, kN, D)
    x_decentered: torch.Tensor         # (B, kN, D)
    first_pn_out: torch.Tensor         # (B, kN, 384)
    first_pn_out_masked_max: torch.Tensor  # (B, M, 384) node-pooled
    knn_center: Optional[torch.Tensor]     # (B, M, D) or None (som_k < 2)
    knn_feature: Optional[torch.Tensor]    # (B, M, 512) or None
    final_pn_out: torch.Tensor         # (B, M, F)
    perm: Optional[torch.Tensor] = None      # (B, kN) sorted pos -> original
    inv_perm: Optional[torch.Tensor] = None  # (B, kN) original -> sorted pos
    onehot: Optional[torch.Tensor] = None    # (B, kN, M) assignment one-hot


class Encoder(nn.Module):
    def __init__(self, cfg: Config, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        D = spatial_dim(cfg)
        kw = dict(activation=cfg.activation, normalization=cfg.normalization,
                  **layer_kw(cfg))
        first_in = 2 * D if cfg.surface_normal else D
        self.first_pointnet = PointResNet(first_in, (64, 128, 256, 384),
                                          generator, sharded_points=True,
                                          **kw)
        if cfg.som_k >= 2:
            self.knnlayer = KNNModule(D, 384, (512, 512), generator, **kw)
            self.final_pointnet = PointNetMLP(D + 512, (768, cfg.feature_num),
                                              generator, **kw)
        else:
            self.knnlayer = None
            self.final_pointnet = PointResNet(
                D + 384, (512, 512, 768, cfg.feature_num), generator, **kw)

    def forward(self, pc: torch.Tensor, sn: torch.Tensor | None,
                node: torch.Tensor,
                node_knn_I: torch.Tensor | None = None, *,
                epoch: int | None = None) -> EncoderOutput:
        """pc (B, N, D) points; sn (B, N, D) normals or None; node
        (B, M, D) SOM nodes; node_knn_I (B, M, >=som_k) or None (computed
        from the input nodes); epoch: the training epoch, for the
        BatchNorm momentum decay."""
        cfg = self.cfg
        B, N, D = pc.shape
        M = node.shape[1]
        k = cfg.k
        if cfg.surface_normal and sn is None:
            raise ValueError("cfg.surface_normal is set but sn is None")

        # -- the point -> node grouping: top-k assignment, the k-stacked
        # points (node-sorted on the sorted path), the one-hot, the node
        # counts and cluster means, the decentered points; one range
        with span(GROUPING):
            assign = assign_topk(pc, node, k)
            min_idx = assign.min_idx                   # (B, kN) int32
            x_stack = pc.repeat(1, k, 1)               # (B, kN, D)
            sn_stack = sn.repeat(1, k, 1) if sn is not None else None

            sort_points = resolve_pooling(cfg, pc.device) == "sorted_window"
            if sort_points:
                # stable sort by node (the counting-sort kernel on a card,
                # up to NODE_SORT_MAX_NODES nodes), with the permutation
                # both ways and point 0's sorted position, its node's first
                # slot; xyz and normals follow by gather
                sort = (node_sort if M <= NODE_SORT_MAX_NODES
                        else node_sort_plain)
                min_idx, perm, inv_perm, point0_idx = sort(min_idx, M)
                rows = perm[..., None].expand(-1, -1, D)
                x_stack = torch.gather(x_stack, 1, rows)
                if sn_stack is not None:
                    sn_stack = torch.gather(sn_stack, 1, rows)
            else:
                perm = inv_perm = point0_idx = None

            # the one-hot is in the compute dtype (exact 0/1); the scatter
            # path's sums below and the segmenter's skip gathers read it
            oh_dtype = compute_dtype(cfg) or torch.float32
            onehot = one_hot(min_idx, M, oh_dtype)     # (B, kN, M)
            split = collectives.axis_size("points") > 1
            # node counts and coordinate sums in f32: over node-sorted rows
            # each node is a run that segment_sums adds up (the kernel on a
            # card), else through the one-hot
            if sort_points:
                counts, cluster_sum = segment_sums(min_idx, x_stack.float(),
                                                   M)
            else:
                counts = onehot.sum(1, dtype=torch.float32)
                cluster_sum = torch.bmm(onehot.float().transpose(1, 2),
                                        x_stack.float())
            # under a split points axis: the sums over every rank's points
            counts = collectives.reduce_points(counts)  # (B, M)
            mask_row_max = ((counts > 0) if sort_points or split
                            else assign.mask_row_max)

            # the nodes recentered to the actual cluster means
            cluster_sum = collectives.reduce_points(cluster_sum)
            som_node = cluster_sum / (counts[..., None] + 1e-5)  # (B, M, D)

            # per-point centers and decentering
            centers = torch.gather(
                som_node, 1, min_idx.long()[..., None].expand(-1, -1, D))
            x_decentered = x_stack - centers

        # -- first PointNet over the kN points -------------------------------
        if cfg.surface_normal:
            first_in = torch.cat([x_decentered, sn_stack], -1)
        else:
            first_in = x_decentered
        if cfg.remat and self.training:
            # the recomputation in the backward must not update the running
            # statistics a second time (recomputation()); the stack draws
            # no random numbers, so no generator state is kept for it, and
            # reading the CUDA generator's state is not allowed while a
            # graph is captured
            first_pn_out = checkpoint(
                self.first_pointnet, first_in, epoch=epoch,
                use_reentrant=False, preserve_rng_state=False,
                context_fn=lambda: (contextlib.nullcontext(),
                                    recomputation()))
        else:
            first_pn_out = self.first_pointnet(first_in, epoch=epoch)

        # -- node pooling -----------------------------------------------------
        if sort_points:
            pooled = segment_max_fast(first_pn_out.contiguous(), min_idx, M,
                                      counts=counts, point0_idx=point0_idx)
        else:
            pooled = segment_max(first_pn_out, min_idx, M,
                                 counts=counts)              # (B, M, 384)

        if self.knnlayer is not None:
            # the kNN graph is built on the INPUT nodes, before recentering;
            # the module gathers the recentered nodes through it
            if node_knn_I is None:
                knn_I = knn(node, cfg.som_k)
            else:
                knn_I = node_knn_I[:, :, :cfg.som_k]
            knn_center, knn_feature = self.knnlayer(
                som_node, pooled, knn_I, cfg.som_k_type, epoch=epoch)
            dt = torch.promote_types(knn_center.dtype, knn_feature.dtype)
            final_in = torch.cat([knn_center.to(dt), knn_feature.to(dt)], -1)
        else:
            knn_center = knn_feature = None
            dt = torch.promote_types(som_node.dtype, pooled.dtype)
            final_in = torch.cat([som_node.to(dt), pooled.to(dt)], -1)
        final_pn_out = self.final_pointnet(final_in, epoch=epoch).float()

        # -- global max over nodes, in f32, with FIRST-WINNER gradient
        # routing: exact ties across nodes are common (overlapping kNN
        # neighbourhoods make whole node rows equal), and amax would split
        # their gradient evenly where the JAX package and the reference
        # send it all to the first winner.  argmax returns the first max.
        am = final_pn_out.argmax(1, keepdim=True)      # (B, 1, F)
        feature = torch.gather(final_pn_out, 1, am).squeeze(1)   # (B, F)

        return EncoderOutput(
            feature=feature, min_idx=min_idx, mask_row_max=mask_row_max,
            counts=counts, som_node=som_node, centers=centers,
            x_stack=x_stack,
            sn_stack=sn_stack if sn_stack is not None else x_stack,
            x_decentered=x_decentered, first_pn_out=first_pn_out,
            first_pn_out_masked_max=pooled, knn_center=knn_center,
            knn_feature=knn_feature, final_pn_out=final_pn_out,
            perm=perm, inv_perm=inv_perm, onehot=onehot)


class Transformer(nn.Module):
    """The reference's rotation regressor: sin(theta) (B, 1) in [-1, 1] of
    a cloud (B, N, ``in_features``, default the spatial dimension).  Dead
    in the reference (built, its use commented out) and here;
    ``rotation_matrix_y`` builds the rotation that the commented block
    applies.  Float32, BatchNorm as every layer's; dropout after the two
    hidden layers in training when ``cfg.dropout > 0.1``, drawn from the
    forward's ``generator``."""

    def __init__(self, cfg: Config, generator: torch.Generator,
                 in_features: Optional[int] = None):
        super().__init__()
        self.rate = cfg.dropout
        kw = dict(activation=cfg.activation, normalization=cfg.normalization,
                  momentum=cfg.bn_momentum,
                  bn_momentum_decay_step=cfg.bn_momentum_decay_step,
                  bn_momentum_decay=cfg.bn_momentum_decay)
        cin = spatial_dim(cfg) if in_features is None else in_features
        self.PointNetMLP_0 = PointNetMLP(cin, (32, 64, 128), generator, **kw)
        self.PointNetMLP_1 = PointNetMLP(256, (256, 256), generator, **kw)
        self.PointLayer_0 = PointLayer(256, 128, generator, **kw)
        self.PointLayer_1 = PointLayer(128, 64, generator, **kw)
        self.PointLayer_2 = PointLayer(64, 1, generator, activation=None,
                                       normalization=None)

    def forward(self, x: torch.Tensor, epoch: Optional[int] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        from .heads import dropout
        first = self.PointNetMLP_0(x, epoch)
        feat1 = first.amax(1, keepdim=True)                  # (B, 1, 128)
        second = self.PointNetMLP_1(
            torch.cat([first, feat1.expand_as(first)], -1), epoch)
        h = self.PointLayer_0(second.amax(1), epoch=epoch)   # (B, 128)
        if self.training and self.rate > 0.1:
            h = dropout(h, self.rate, generator)
        h = self.PointLayer_1(h, epoch=epoch)
        if self.training and self.rate > 0.1:
            h = dropout(h, self.rate, generator)
        return torch.tanh(self.PointLayer_2(h))


def rotation_matrix_y(sin_theta: torch.Tensor) -> torch.Tensor:
    """(B, 1) sin(theta) -> (B, 3, 3) rotation about the y axis."""
    s = sin_theta[:, 0]
    c = torch.sqrt(1.0 + 1e-5 - s * s)
    z, o = torch.zeros_like(s), torch.ones_like(s)
    return torch.stack([torch.stack([c, z, s], -1),
                        torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], 1)
