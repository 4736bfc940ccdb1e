"""MDGAT, the paper model: eval and train forward, all five descriptor modes.

Port of ``mdgat_tpu/models/mdgat.py`` (reference ``MDGAT``,
``models/mdgat.py:315-603``): encoders -> 2L-layer attentional GNN with the
dynamic top-k schedule -> final 1x1 projection -> scaled descriptor
inner-product scores -> dustbin log-Sinkhorn -> match decision (+ the loss
when ground truth is given).

Encoders by ``config.descriptor`` (``mdgat_tpu/models/mdgat.py:50-81``):
``FPFH`` and ``FPFH_gloabal`` (sic) sum a keypoint encoder and an FPFH
encoder (the latter global-aware); ``FPFH_only`` has the FPFH encoder
alone; ``pointnet`` / ``pointnetmsg`` learn the descriptors from the raw
clouds ``cloud0`` / ``cloud1`` (``models/pointnet_encoder.py``), cast to the
compute dtype first. For those two modes SuperGlue also builds a keypoint
encoder and a ``pointnetDescriptorEncoder`` that its forward never calls,
as the reference does. Staged training of the pointnet modes
(``config.train_step``, ``models/mdgat.py:398-420`` of the reference):
step 1 runs no GNN and no final projection and scores the encoder output;
step 2 detaches the descriptors (the encoder's gradients are None where
JAX's are zero); step 3 is the joint step. As in the JAX package this holds
in eval mode too.

Module names follow the reference, so ``state_dict()`` keys are the
upstream ones (``kenc.encoder.*``, ``denc.encoder.*``, ``denc.encoder2.*``,
``penc.*``, ``gnn.layers.*``, ``final_proj.*``, ``bin_score``) and reference
``.pth`` files load with ``strict=True``.

Precision: the encoders and the GNN run in ``compute_dtype``; the scores,
the transport, the decision and the loss run in at least float32
(``models/mdgat.py:230-239`` of the JAX package). On a CUDA device with
``use_kernels`` the GNN layers and the Sinkhorn run the hand-written
kernels; everything else is plain PyTorch.

``module.train()`` selects the training forward (``apply(train=True)`` of
the JAX package): BatchNorm on batch statistics over valid points, running
stats updated cloud 0 then cloud 1; with ``use_kernels`` on a CUDA device
each GNN layer is the whole-layer train kernels (``config.train_layer``, the
default; without it only the attention is a kernel pair) and the transport
is the Sinkhorn kernel with its replay backward, so ``loss.backward()`` runs
on hand-written kernels too. With ``train_layer`` a CPU model takes the
whole-layer kernels' plain twin, whose variance is single-pass.

Data-parallel training (``parallel/smap.py``) passes the process group of
the ranks: the training forward then runs under ``bn_cross_replica(group)``
(``apply(axis_name=...)`` of the JAX package), so every training-mode
BatchNorm, plain or inside the whole-layer train kernels, normalises with
the statistics of the global batch. An eval-mode forward uses the running
statistics and issues no collective, whatever group it is given.

Context parallelism (``seq_group``, ``apply(seq_axis=...)`` of the JAX
package): the inputs hold this seq member's contiguous block of each
cloud's keypoints (``parallel/mesh.py::shard_batch``) and the raw clouds
whole. One gather (``input_gather``) gives the masks and the ground truth
of the whole clouds; the encoders run on the member's rows, the GNN on its
query rows against gathered keys (``models/gnn.py``), with the k-schedule
read at the global keypoint count; the final descriptors are gathered
(``tail_gather``) and the scores, the transport, the decision and the loss
run on the whole clouds, the same on every member. Outputs are full-N. The
training step (``parallel/smap.py``) scales the loss cotangent by 1/S so
the replicated tail's gradients are counted once. ``FPFH_gloabal`` is
refused under a seq axis: its encoder max-pools over the whole cloud, which
a member's block does not hold (the JAX package pools each block alone).

``config.loss_kernel`` routes the gap loss through
``ops/cuda/gap_loss.py::gap_loss_kernel`` (the margin kernels on a CUDA
tensor, their plain twins on a CPU tensor), in both modes and independently
of ``use_kernels``, as ``pallas_loss`` does in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.distributed as dist
from torch import nn

from mdgat_tpu_torch.core.config import POINTNET_DESCRIPTORS, Config
from mdgat_tpu_torch.models.encoders import (DescriptorEncoder,
                                             DescriptorGlobalEncoder,
                                             KeypointEncoder,
                                             PointnetDescriptorEncoder)
from mdgat_tpu_torch.models.gnn import AttentionalGNN
from mdgat_tpu_torch.models.pointnet_encoder import PointnetEncoder
from mdgat_tpu_torch.ops.cuda.gap_loss import gap_loss_kernel
from mdgat_tpu_torch.ops.cuda.sinkhorn import log_optimal_transport_kernel
from mdgat_tpu_torch.ops.losses import gap_loss, superglue_nll_loss, triplet_loss
from mdgat_tpu_torch.ops.matching import match_decision
from mdgat_tpu_torch.ops.mlp import Conv1x1, bn_cross_replica
from mdgat_tpu_torch.ops.transport import (assemble_full_scores,
                                           log_optimal_transport)
from mdgat_tpu_torch.parallel.mesh import all_gather


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64,
            "bfloat16": torch.bfloat16}[name]


class MDGAT(nn.Module):
    def __init__(self, config: Config, device=None):
        super().__init__()
        self.config = config
        dtype = torch_dtype(config.param_dtype)
        fd = config.descriptor_dim
        kw = dict(dtype=dtype, device=device)
        desc = config.descriptor
        if desc in ("FPFH", "FPFH_gloabal"):
            self.kenc = KeypointEncoder(fd, config.keypoint_encoder, **kw)
        if desc in ("FPFH", "FPFH_only"):
            self.denc = DescriptorEncoder(fd, config.descriptor_encoder, **kw)
        elif desc == "FPFH_gloabal":
            self.denc = DescriptorGlobalEncoder(fd, config.descriptor_encoder,
                                                **kw)
        elif desc in POINTNET_DESCRIPTORS:
            superglue = config.net == "superglue"
            self.penc = PointnetEncoder(fd, config.keypoint_encoder,
                                        msg=desc == "pointnetmsg",
                                        superglue=superglue, **kw)
            if superglue:
                # built, never called (superglue.py:345-360, 421-424)
                self.kenc = KeypointEncoder(fd, config.keypoint_encoder, **kw)
                self.denc = PointnetDescriptorEncoder(fd, **kw)
        else:
            raise ValueError(f"Invalid descriptor: {desc}")
        self.gnn = AttentionalGNN(fd, config.gnn_layer_names,
                                  config.num_heads, **kw)
        self.final_proj = Conv1x1(fd, fd, **kw)
        self.bin_score = nn.Parameter(torch.tensor(1.0, **kw))

    @torch.no_grad()
    def reset_parameters(self, seed: int):
        """Seeded init with ``torch.nn.Conv1d``'s defaults (kaiming-uniform,
        zero final biases where the reference zeroes them), BN at identity,
        ``bin_score`` 1.0 (``models/mdgat.py:359``)."""
        g = torch.Generator(device="cpu").manual_seed(seed)
        for name in ("kenc", "denc", "penc"):
            if hasattr(self, name):
                getattr(self, name).reset_parameters(g)
        for layer in self.gnn.layers:
            layer.reset_parameters(g)
        self.final_proj.reset_parameters(g)
        self.bin_score.fill_(1.0)

    def forward(self, data: Dict[str, torch.Tensor],
                return_full_scores: bool = False, group=None,
                seq_group=None) -> Dict[str, torch.Tensor]:
        """``data``: keypoints0/1 [B, N, 3], scores0/1 [B, N], the FPFH
        modes' descriptors0/1 [B, N, 33] or the pointnet modes' cloud0/1
        [B, Np, 8], optional mask0/1 [B, N] bool and gt_matches0/1 [B, N]
        int (-1 = unmatched). Returns matches0/1, matching_scores0/1, with
        ground truth loss [B], and with ``return_full_scores`` the
        reference's [B, N+1, M+1] transport (``scores``). ``group``, a
        ``torch.distributed`` process group, makes the training-mode
        BatchNorm statistics those of its ranks' batches together.
        ``seq_group``, the process group of a seq axis: the keypoint-axis
        inputs are this member's block, the outputs are whole."""
        if seq_group is not None and self.config.descriptor == "FPFH_gloabal":
            raise ValueError("descriptor FPFH_gloabal pools over the whole "
                             "cloud: it cannot run with --seq_parallel > 1")
        with bn_cross_replica(group if self.training else None):
            return self._forward(data, return_full_scores, seq_group)

    def _forward(self, data, return_full_scores, seq_group=None):
        cfg = self.config
        dt = torch_dtype(cfg.compute_dtype)
        mask0, mask1 = data.get("mask0"), data.get("mask1")
        # the whole clouds' masks and ground truth: one gather (their values
        # index the global columns)
        whole = {k: data[k] for k in ("mask0", "mask1", "gt_matches0",
                                      "gt_matches1") if k in data}
        if seq_group is not None and whole:
            whole = dict(zip(whole, all_gather(
                [v.long() for v in whole.values()], seq_group,
                "input_gather")))
            whole.update({k: whole[k].bool() for k in ("mask0", "mask1")
                          if k in whole})
        desc0, desc1 = (self.encode(data, side, dt, mask)
                        for side, mask in (("0", mask0), ("1", mask1)))

        run_gnn = True
        if cfg.descriptor in POINTNET_DESCRIPTORS:
            if cfg.train_step == 1:
                run_gnn = False
            elif cfg.train_step == 2:
                desc0, desc1 = desc0.detach(), desc1.detach()
        kmask0, kmask1 = whole.get("mask0"), whole.get("mask1")
        if run_gnn:
            # the k-schedule reads the global keypoint count (the local
            # count is N/S under a seq axis)
            n = desc0.shape[1] * (1 if seq_group is None
                                  else dist.get_world_size(seq_group))
            desc0, desc1 = self.gnn(desc0, desc1, cfg.layer_k_schedule(n),
                                    mask0, mask1,
                                    use_kernels=cfg.use_kernels,
                                    train_layer=cfg.train_layer,
                                    seq_group=seq_group,
                                    key_masks=(kmask0, kmask1))
            mdesc0, mdesc1 = self.final_proj(desc0), self.final_proj(desc1)
        else:
            mdesc0, mdesc1 = desc0, desc1
        if seq_group is not None:
            # the tail runs on the whole clouds, the same on every member
            mdesc0, mdesc1 = all_gather((mdesc0, mdesc1), seq_group,
                                        "tail_gather")
            mask0, mask1 = kmask0, kmask1

        ot_dtype = torch.float32 if dt == torch.bfloat16 else dt
        scores = torch.matmul(mdesc0.to(ot_dtype),
                              mdesc1.to(ot_dtype).transpose(1, 2))
        scores = scores / math.sqrt(cfg.descriptor_dim)
        alpha = self.bin_score.to(ot_dtype)
        transport = (log_optimal_transport_kernel
                     if cfg.use_kernels and scores.device.type == "cuda"
                     else log_optimal_transport)
        ot = transport(scores, alpha, cfg.sinkhorn_iterations, mask0, mask1)
        with torch.no_grad():
            res = match_decision(ot, cfg.loss_method, cfg.match_threshold,
                                 cfg.mutual_check, mask0, mask1)
        out = {"matches0": res.matches0, "matches1": res.matches1,
               "matching_scores0": res.matching_scores0,
               "matching_scores1": res.matching_scores1}
        if "gt_matches0" in data:
            gt0 = whole["gt_matches0"].long()
            gt1 = whole["gt_matches1"].long()
            if cfg.loss_method == "superglue":
                out["loss"] = superglue_nll_loss(ot, gt0, gt1, mask0, mask1)
            elif cfg.loss_method == "triplet_loss":
                out["loss"] = triplet_loss(ot, gt0, gt1,
                                           cfg.triplet_loss_gamma, mask0,
                                           mask1)
            elif cfg.loss_method == "gap_loss":
                loss_fn = gap_loss_kernel if cfg.loss_kernel else gap_loss
                out["loss"] = loss_fn(ot, gt0, gt1, cfg.triplet_loss_gamma,
                                      mask0, mask1)
            else:
                raise ValueError(f"Invalid loss_method: {cfg.loss_method}")
        if return_full_scores:
            out["scores"] = assemble_full_scores(ot)
        return out

    def encode(self, data: Dict[str, torch.Tensor], side: str,
               dt: torch.dtype, mask=None) -> torch.Tensor:
        """One cloud's descriptors [B, N, D] in ``dt`` (``side`` "0" or
        "1"); ``mask`` keeps padded points out of the FPFH encoders' BN
        statistics (the pointnet encoder takes none)."""
        kpts = data["keypoints" + side].to(dt)
        scores = data["scores" + side].to(dt)
        desc = self.config.descriptor
        if desc in POINTNET_DESCRIPTORS:
            return self.penc(data["cloud" + side].to(dt), kpts, scores)
        out = self.denc(data["descriptors" + side].to(dt), mask)
        if desc == "FPFH_only":
            return out
        return out + self.kenc(kpts, scores, mask)
