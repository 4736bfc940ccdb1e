"""Configuration for the PyTorch port.

A copy of ``mdgat_tpu/core/config.py`` (that package's ``__init__`` pulls
in JAX, so the port never imports it). Same fields and defaults, same
``train_defaults()`` / ``test_defaults()`` presets of the reference entry
points. The JAX package's accelerator knobs (Pallas gates, shard_map, mesh
sizes, layer scanning, remat) collapse into one switch, ``use_kernels``: the
device a model is placed on decides where it runs, and on a CUDA device
``use_kernels`` routes the GNN layers and the Sinkhorn through the
hand-written kernels of ``mdgat_tpu_torch/csrc``.

The multi-process fields keep the JAX package's names and defaults:
``coordinator_address`` (``host:port``, empty for one process or a torchrun
environment), ``num_processes`` and ``process_id``; each process is one rank
with one device (``parallel/multihost.py``). ``seq_parallel`` (the JAX
package's name and default) is the size S of the context-parallel ``seq``
axis: the W ranks form W / S data rows of S ranks each, and the members of
a row split the keypoints of the row's pairs.

``data_parallel`` and ``shard_map`` (the JAX package's names and defaults)
are ``Matcher``'s: one process serves a batch over a ``data_parallel`` x
``seq_parallel`` grid of model replicas, one thread and one device a cell
(``parallel/smap.py::make_eval_runtime``); ``resolve_shard_map`` says
whether the grid runs. The CLIs leave both at their defaults: there one
rank is one device.

In eval mode that is the whole-layer kernels and the Sinkhorn forward. In
training mode, with ``train_layer`` (the default, the counterpart of the JAX
package's ``pallas_train_layer``), every GNN layer runs the whole-layer
train kernels (``ops/cuda/train_layer.py``: attention, merge, both MLP
convs, batch-statistic BatchNorm and the residual, forward and backward),
and the transport runs the Sinkhorn forward with its replay backward. With
``train_layer=False`` only each layer's attention runs on kernels (the
fused-MHA forward / backward pair) and the layer's MLP and BatchNorm are
plain PyTorch under autograd. The encoders and the score product stay plain
PyTorch on either route.

``exact_topk`` (off by default, the JAX package's ``pallas_exact_topk``)
picks the arm of the attention kernel's top-k selection on the kernel
routes: the exact k-th value, or by default the fast value bisection, whose
kept set can hold a few near-tie keys more than the top k. As in the JAX
package it acts on the kernel routes only; the plain route selects the
exact top-k whatever it says. ``kernel_twins`` (no CLI flag, the
counterpart of the JAX package's ``pallas_interpret``) sends a CPU model
down the kernel routes, where every wrapper takes its plain twin: the
tests hold the fast arm against the JAX package's kernels run in interpret
mode with it.

``cuda_graphs`` (on by default, no CLI flag) captures a train step and an
eval forward on the card as CUDA graphs, once per shape bucket, and
replays them (``utils/graphs.py``): the counterpart of the JAX package's
``jax.jit``, and off where JAX's ``disable_jit`` would be. The CPU, the
plain route (``use_kernels=False``), data- and seq-parallel steps,
``--debug_nans`` and MDGAT's clouds of more than 1024 keypoints stay eager
(``utils/graphs.py::use_graphs``; LightGlue captures at any size).

``net="lightglue"`` builds LightGlue (``models/lightglue.py``, Lindenberger
et al., ICCV 2023) on the serving path: it reads ``descriptor_dim``,
``num_heads``, ``L`` (its ``n_layers``) and ``match_threshold`` (its
``filter_threshold``), and one field of its own, ``keypoint_scale`` (the
metres a keypoint coordinate is divided by, upstream's
``normalize_keypoints`` carried to 3-d). Adaptive depth and width are not
ported. No LightGlue loss exists: training refuses the net.

``loss_kernel`` (off by default, the counterpart of the JAX package's
``pallas_loss``) sends the gap loss through the margin kernels of
``ops/cuda/gap_loss.py``, forward and backward, in train and eval mode and
whatever ``use_kernels`` says; on a CPU tensor it takes their plain twins.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


# The reference's k-schedule default (train.py:61, test.py:83): None entries
# mean full attention for that layer.
DEFAULT_K: Tuple[Optional[int], ...] = (128, None, 128, None, 64, None, 64, None)
# the descriptor modes that learn descriptors from the raw clouds
POINTNET_DESCRIPTORS = ("pointnet", "pointnetmsg")


@dataclasses.dataclass
class Config:
    # --- model architecture (reference models/mdgat.py:316-323) ---
    descriptor_dim: int = 128
    keypoint_encoder: Tuple[int, ...] = (32, 64, 128)
    descriptor_encoder: Tuple[int, ...] = (64, 128)  # 'descritor_encoder' (sic) upstream
    num_heads: int = 4
    L: int = 9                      # GNN has 2*L alternating self/cross layers
    k: Optional[Tuple[Optional[int], ...]] = DEFAULT_K
    net: str = "mdgat"              # mdgat | superglue | raw | lightglue
    descriptor: str = "FPFH"        # FPFH | FPFH_gloabal | FPFH_only | pointnet | pointnetmsg
    sinkhorn_iterations: int = 20   # CLI default (train.py:21); model default was 100
    match_threshold: float = 0.2
    loss_method: str = "gap_loss"   # superglue | triplet_loss | gap_loss
    triplet_loss_gamma: float = 0.5
    mutual_check: bool = False
    train_step: int = 3             # staged training for pointnet descriptors
    # --- LightGlue (net="lightglue", models/lightglue.py) ---
    keypoint_scale: float = 30.0    # metres a keypoint coordinate is divided by

    # --- data pipeline (reference load_data.py) ---
    dataset: str = "kitti"
    keypoints: str = "USIP"
    max_keypoints: int = 512
    ensure_kpts_num: bool = True
    threshold: float = 0.5          # GT correspondence distance threshold (m)
    memory_is_enough: bool = True
    train_path: str = "./KITTI/"
    keypoints_path: str = "./KITTI/keypoints/tsf_256_FPFH_16384-512-k1k16-2d-nonoise"
    txt_path: str = "./KITTI/preprocess-random-full"
    score_min: float = 10.0         # USIP score filter (load_data.py:183)

    # --- training (reference train.py) ---
    learning_rate: float = 1e-4
    epoch: int = 1000
    batch_size: int = 64
    resume: bool = False
    resume_model: str = "./your_model.pth"
    model_out_path: str = "./checkpoint"

    # --- execution ---
    compute_dtype: str = "float32"  # float32 | bfloat16 | float64
    param_dtype: str = "float32"
    use_kernels: bool = True        # CUDA tensors run the csrc/ kernels
    train_layer: bool = True        # training: whole-layer kernels (else fused MHA + plain MLP)
    loss_kernel: bool = False       # gap loss through the margin kernels
    exact_topk: bool = False        # kernel routes: exact top-k (else value bisection)
    kernel_twins: bool = False      # CPU tensors take the kernel routes' twins
    cuda_graphs: bool = True        # capture steps as CUDA graphs (utils/graphs.py)
    prefetch: int = 2
    seed: int = 0

    # --- multi-process (parallel/multihost.py) ---
    coordinator_address: str = ""
    num_processes: int = 0
    process_id: int = -1
    seq_parallel: int = 1           # ranks that split one pair's keypoints
    # --- one process over several devices (parallel/smap.py) ---
    data_parallel: int = 1          # model replicas the rows are split over
    shard_map: Optional[bool] = None  # None = auto (resolve_shard_map)

    # ------------------------------------------------------------------
    @property
    def gnn_layer_names(self) -> List[str]:
        # both nets alternate self/cross for 2L layers
        # (models/mdgat.py:335, models/superglue.py:232)
        return ["self", "cross"] * self.L

    def layer_k_schedule(self, num_keypoints: int) -> List[Optional[int]]:
        """Per-layer top-k values (None = full attention).

        Mirrors the gating in the reference GNN forward
        (``models/mdgat.py:268-272``): layer i is dynamic iff
        ``i > 2L - 1 - len(k)`` with ``k = k_list[i - 2L + len(k_list)]``.
        ``net='raw'`` (or k=None) disables dynamic attention everywhere
        (``train.py:130-132``).
        """
        n_layers = 2 * self.L
        if self.k is None or self.net in ("raw", "superglue"):
            return [None] * n_layers
        ks: List[Optional[int]] = []
        klist = list(self.k)
        for i in range(n_layers):
            if i > n_layers - 1 - len(klist):
                kk = klist[i - n_layers + len(klist)]
                if kk is not None and kk >= num_keypoints:
                    kk = None  # top-k over >= all points is full attention
                ks.append(kk)
            else:
                ks.append(None)
        return ks

    def resolve_shard_map(self, n_data: int) -> bool:
        """Whether ``Matcher`` serves over an ``n_data`` x ``seq_parallel``
        grid of replicas (``parallel/smap.py::make_eval_runtime``), or runs
        one forward on one device. An explicit ``shard_map`` wins; auto
        (None) turns the grid on when it has more than one cell and a kernel
        route is on (``use_kernels`` in the role of the JAX package's
        ``use_pallas`` / ``pallas_attention``, ``loss_kernel`` in that of
        ``pallas_loss``), as ``mdgat_tpu/core/config.py::resolve_shard_map``
        does."""
        multi = n_data > 1 or self.seq_parallel > 1
        if self.shard_map is not None:
            return self.shard_map and multi
        return multi and (self.use_kernels or self.loss_kernel)

    def model_name(self) -> str:
        """Run-name scheme of the reference (``train.py:130-136``)."""
        kstr = _k_repr(self.k)
        base = "{}-k{}-batch{}-{}-{}-{}".format(
            self.net, kstr, self.batch_size, self.loss_method,
            self.descriptor, self.keypoints)
        if not self.mutual_check:
            base = "nomutualcheck-" + base
        return base

    def run_dir(self, root: str) -> str:
        """Log/checkpoint directory scheme (``train.py:138-151``)."""
        kstr = _k_repr(self.k)
        path = "{}/{}/{}{}-k{}-{}-{}".format(
            root, self.dataset, self.net, self.L, kstr,
            self.loss_method, self.descriptor)
        if self.descriptor in POINTNET_DESCRIPTORS:
            path = "{}/train_step{}".format(path, self.train_step)
        return "{}/{}".format(path, self.model_name())

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _k_repr(k) -> str:
    if k is None:
        return "None"
    return "[{}]".format(", ".join(str(x) for x in k))


def train_defaults(**overrides) -> Config:
    """Preset matching ``train.py`` argparse defaults (``train.py:16-123``)."""
    return Config().replace(**overrides)


def test_defaults(**overrides) -> Config:
    """Preset matching ``test.py`` argparse defaults (``test.py:18-126``).

    Divergences from the train preset, as in the reference: batch_size=1,
    max_keypoints=256, ensure_kpts_num=False, loss_method='triplet_loss',
    memory_is_enough=False.
    """
    cfg = Config().replace(
        batch_size=1,
        max_keypoints=256,
        ensure_kpts_num=False,
        loss_method="triplet_loss",
        memory_is_enough=False,
    )
    return cfg.replace(**overrides)
