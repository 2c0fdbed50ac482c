"""Vision classifier with the ``densenet_onnx`` fixture contract, in PyTorch.

The counterpart of ``client_tpu.models.vision``: input ``data_0`` FP32
[3,224,224] (CHW), output ``fc6_1`` FP32 [num_classes,1,1], classification
labels ``class_i``; and the ensemble's front stage ``preprocess`` (raw UINT8
HWC image -> normalised FP32 CHW [3,224,224] through the normalize kernel).

:class:`DenseNetish` computes what the flax module computes, in NCHW (the
wire's own CHW order, so no transpose; channels concatenate in the same
order either way):

- bfloat16 activations, convolutions and the dense layer; float32 params
  cast to bfloat16 once when loaded (flax casts them at each use: the same
  values);
- GroupNorm over 8 groups of contiguous channels with float32 statistics,
  epsilon 1e-6 (flax's, not torch's 1e-5), output bfloat16;
- flax's SAME padding, which is asymmetric: ``total = max((ceil(n/s)-1)*s
  + k - n, 0)``, ``total // 2`` before and the rest after (the 7x7 stride-2
  stem pads 224 by (2, 3); the 3x3 stride-2 max pool pads 112 by (0, 1)
  with -inf); average pools are VALID and floor;
- the global mean accumulates in float32 and rounds to bfloat16.

Convolutions, GroupNorm, the pools and the dense layer are PyTorch library
calls (cuDNN / cuBLAS on the card), as the JAX package leaves them to XLA
outside any Pallas kernel.

Tensor parallel (``tensor_parallel > 1``, or :meth:`DenseNetish.shard`): the
output channels of every convolution and of the dense layer are split over
the ``model`` axis of a (1, tp) mesh where they divide (JAX's
``shard_params`` rule); each shard computes its channels on its device from
the whole input, and the slices are gathered along the channels on the
first device, where everything else (norms, pools, the mean) runs.

Training: :class:`FunctionalDenseNet` is the same network as ``init`` /
``apply`` over flax's own parameter tree (its names, HWIO kernels, fp32
leaves that require grad, bf16 compute), the form
``parallel.sharded_train_step`` trains; :func:`params_to_torch` carries
JAX's ``module.init`` tree across, and :meth:`DenseNetModel.forward_fn`
gives the served weights through it.

Weights: flax draws its init with ``jax.random``, which torch cannot
reproduce. :func:`draw_params` is the port's own seeded numpy draw in the
flax tree's names and shapes, and :func:`load_jax_params` loads that tree or
the JAX model's own params (exported to numpy), so both packages can run on
the same weights.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import preprocess_image
from ..parallel import Mesh, Sharded, local_devices, move, shard_params, split
from ..utils import as_device_tensor
from .base import Model, TensorSpec

GROUPS = 8
EPSILON = 1e-6


def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax/XLA SAME padding of one axis: (before, after)."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0) -> torch.Tensor:
    top, bottom = _same_pads(x.shape[-2], kernel, stride)
    left, right = _same_pads(x.shape[-1], kernel, stride)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def _frozen(shape: Sequence[int], dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(tuple(shape), dtype=dtype, device=device),
                        requires_grad=False)


def _split_out(params: Sequence[torch.Tensor], devices) -> Optional[List[Sharded]]:
    """Each of ``params``' output channels (dim 0) split over ``devices``,
    or None where they do not divide (the parameters then stay whole)."""
    if len(devices) < 2 or params[0].shape[0] % len(devices):
        return None
    return [split(p.detach(), devices, 0) for p in params]


def _by_channels(fn, x: torch.Tensor, params: Sequence[torch.Tensor],
                 shards: Optional[List[Sharded]]) -> torch.Tensor:
    """``fn(x, *params)``, or with the output channels split: each shard
    computes its slice from the whole ``x`` on its device, and the slices
    are gathered along dim 1 on x's device."""
    if shards is None:
        return fn(x, *params)
    return Sharded([fn(move(x, blocks[0].device), *blocks)
                    for blocks in zip(*(s.shards for s in shards))], 1).full(x.device)


class ConvBlock(nn.Module):
    """3x3 SAME convolution without bias -> GroupNorm(8) -> relu."""

    def __init__(self, in_channels: int, features: int, device="cuda"):
        super().__init__()
        self.weight = _frozen((features, in_channels, 3, 3), torch.bfloat16, device)
        self.scale = _frozen((features,), torch.float32, device)
        self.bias = _frozen((features,), torch.float32, device)
        self.weight_shards: Optional[List[Sharded]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _by_channels(F.conv2d, _pad_same(x, 3, 1), (self.weight,), self.weight_shards)
        x = F.group_norm(x.float(), GROUPS, self.scale, self.bias, eps=EPSILON)
        return F.relu(x.to(torch.bfloat16))

    def load(self, tree: Mapping[str, Any]) -> None:
        _copy(self.weight, tree["Conv_0"]["kernel"], hwio=True)
        _copy(self.scale, tree["GroupNorm_0"]["scale"])
        _copy(self.bias, tree["GroupNorm_0"]["bias"])


class DenseStage(nn.Module):
    """Dense-block flavour: each layer sees the concat of all prior maps."""

    def __init__(self, in_channels: int, growth: int, layers: int, device="cuda"):
        super().__init__()
        self.blocks = nn.ModuleList(
            ConvBlock(in_channels + i * growth, growth, device) for i in range(layers))
        self.out_channels = in_channels + layers * growth

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = torch.cat([x, block(x)], dim=1)
        return x

    def load(self, tree: Mapping[str, Any]) -> None:
        for i, block in enumerate(self.blocks):
            block.load(tree[f"ConvBlock_{i}"])


class DenseNetish(nn.Module):
    """x [N, 3, H, W] (any H, W) -> logits [N, num_classes] float32."""

    def __init__(self, num_classes: int, width: int, stages: Sequence[int] = (2, 2, 2),
                 device="cuda"):
        super().__init__()
        self.num_classes = num_classes
        self.width = width
        self.stages = tuple(stages)
        self.stem = _frozen((width, 3, 7, 7), torch.bfloat16, device)
        channels = width
        dense, transitions = [], []
        for i, layers in enumerate(self.stages):
            growth = width * 2 ** min(i, 2)
            dense.append(DenseStage(channels, growth, layers, device))
            # transition: a ConvBlock to ``growth`` features, then a stride-2 pool
            transitions.append(ConvBlock(dense[-1].out_channels, growth, device))
            channels = growth
        self.dense = nn.ModuleList(dense)
        self.transitions = nn.ModuleList(transitions)
        self.fc_weight = _frozen((num_classes, channels), torch.bfloat16, device)
        self.fc_bias = _frozen((num_classes,), torch.bfloat16, device)
        self.mesh: Optional[Mesh] = None
        self.stem_shards: Optional[List[Sharded]] = None
        self.fc_shards: Optional[List[Sharded]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _by_channels(lambda x, w: F.conv2d(x, w, stride=2),
                         _pad_same(x.to(torch.bfloat16), 7, 2), (self.stem,), self.stem_shards)
        x = F.max_pool2d(_pad_same(x, 3, 2, float("-inf")), 3, stride=2)
        for stage, transition in zip(self.dense, self.transitions):
            x = F.avg_pool2d(transition(stage(x)), 2, stride=2)
        x = x.float().mean(dim=(2, 3)).to(torch.bfloat16)  # global average pool
        return _by_channels(F.linear, x, (self.fc_weight, self.fc_bias), self.fc_shards).float()

    def shard(self, mesh: Mesh) -> None:
        """Split the output channels of every convolution and of the dense
        layer over ``mesh``'s ``model`` axis where they divide (the dense
        bias with its weight); a mesh of one shard undoes it. Re-applied
        by :meth:`load`."""
        self.mesh = mesh
        devices = mesh.axis_devices("model")
        self.stem_shards = _split_out((self.stem,), devices)
        for block in self.modules():
            if isinstance(block, ConvBlock):
                block.weight_shards = _split_out((block.weight,), devices)
        self.fc_shards = _split_out((self.fc_weight, self.fc_bias), devices)

    def load(self, params: Mapping[str, Any]) -> None:
        """Copy a flax param tree (``{"params": {...}}`` or its inner dict,
        numpy leaves) into the module."""
        tree = params.get("params", params)
        _copy(self.stem, tree["Conv_0"]["kernel"], hwio=True)
        for i, (stage, transition) in enumerate(zip(self.dense, self.transitions)):
            stage.load(tree[f"DenseStage_{i}"])
            transition.load(tree[f"ConvBlock_{i}"])
        _copy(self.fc_weight, np.asarray(tree["Dense_0"]["kernel"]).T)
        _copy(self.fc_bias, tree["Dense_0"]["bias"])
        if self.mesh is not None:
            self.shard(self.mesh)


def _copy(param: nn.Parameter, value, hwio: bool = False) -> None:
    """Load one float32 array into ``param`` (HWIO conv kernels go to OIHW)."""
    arr = np.asarray(value)
    if hwio:
        arr = arr.transpose(3, 2, 0, 1)
    if arr.dtype != np.float32 or arr.shape != tuple(param.shape):
        raise ValueError(f"expected float32 {list(param.shape)} (torch layout), got "
                         f"{arr.dtype} {list(arr.shape)}")
    param.copy_(torch.from_numpy(np.array(arr, order="C")))  # a writable copy


def _flax_shapes(num_classes: int, width: int, stages: Sequence[int]):
    """(path, shape, kind) of every leaf of the flax tree, in init order."""
    leaves = [(("Conv_0", "kernel"), (7, 7, 3, width), "conv")]
    channels = width
    for i, layers in enumerate(stages):
        growth = width * 2 ** min(i, 2)
        for j in range(layers):
            prefix = (f"DenseStage_{i}", f"ConvBlock_{j}")
            leaves += _block_shapes(prefix, channels + j * growth, growth)
        leaves += _block_shapes((f"ConvBlock_{i}",), channels + layers * growth, growth)
        channels = growth
    leaves += [(("Dense_0", "kernel"), (channels, num_classes), "dense"),
               (("Dense_0", "bias"), (num_classes,), "zeros")]
    return leaves


def _block_shapes(prefix, in_channels, features):
    return [(prefix + ("Conv_0", "kernel"), (3, 3, in_channels, features), "conv"),
            (prefix + ("GroupNorm_0", "scale"), (features,), "ones"),
            (prefix + ("GroupNorm_0", "bias"), (features,), "zeros")]


def draw_params(num_classes: int = 1000, width: int = 32, stages: Sequence[int] = (2, 2, 2),
                seed: int = 0) -> Dict[str, Any]:
    """The port's default weights: a flax-shaped tree ``{"params": {...}}``
    of float32 numpy arrays. Conv and dense kernels are normal draws from
    ``np.random.default_rng(seed)`` with variance 1/fan_in (flax's
    lecun_normal scale, not its truncation), in the order of the flax tree;
    GroupNorm scales are ones and biases zeros, as flax initialises them."""
    rng = np.random.default_rng(seed)
    tree: Dict[str, Any] = {}
    for path, shape, kind in _flax_shapes(num_classes, width, stages):
        if kind == "ones":
            value = np.ones(shape, np.float32)
        elif kind == "zeros":
            value = np.zeros(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[:-1]))
            value = (rng.standard_normal(shape) * fan_in ** -0.5).astype(np.float32)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return {"params": tree}


def flops_per_image(num_classes: int, width: int, stages: Sequence[int], size: int = 224) -> int:
    """Multiply-adds x 2 of the convolutions and the dense layer for one
    ``size`` x ``size`` image (norms, pools and the mean left out)."""
    def conv(hw, k, cin, cout):
        return 2 * hw * hw * k * k * cin * cout

    out = (size + 1) // 2          # the stem: 7x7 stride 2, SAME
    total = conv(out, 7, 3, width)
    hw = (out + 1) // 2            # the max pool: stride 2, SAME
    channels = width
    for i, layers in enumerate(stages):
        growth = width * 2 ** min(i, 2)
        for j in range(layers):
            total += conv(hw, 3, channels + j * growth, growth)
        total += conv(hw, 3, channels + layers * growth, growth)
        channels = growth
        hw //= 2                   # the average pool: VALID
    return total + 2 * channels * num_classes


# -- the trainable functional densenet (flax's tree, fp32 params) ---------------


def _apply_out(fn, x: torch.Tensor, kernel) -> torch.Tensor:
    """``fn(x, kernel)``, or per output-channel block of a :class:`Sharded`
    kernel, the blocks gathered along dim 1 on x's device (differentiable
    through the gather)."""
    return _by_channels(fn, x, (kernel,), [kernel] if isinstance(kernel, Sharded) else None)


def _conv(x: torch.Tensor, kernel, stride: int = 1) -> torch.Tensor:
    """A SAME convolution without bias in bf16; ``kernel`` HWIO (fp32)."""
    return _apply_out(lambda x, k: F.conv2d(x, k.permute(3, 2, 0, 1).to(torch.bfloat16),
                                            stride=stride),
                      _pad_same(x, kernel.shape[0], stride), kernel)


def _conv_block(x: torch.Tensor, tree: Mapping[str, Any]) -> torch.Tensor:
    x = _conv(x, tree["Conv_0"]["kernel"])
    norm = tree["GroupNorm_0"]
    x = F.group_norm(x.float(), GROUPS, norm["scale"], norm["bias"], eps=EPSILON)
    return F.relu(x.to(torch.bfloat16))


class FunctionalDenseNet:
    """The flax module ``client_tpu.models.vision._build_flax_model`` returns,
    as ``init`` / ``apply`` over a parameter tree: flax's names, HWIO conv
    kernels, a ``[in, out]`` dense kernel, every leaf fp32 (flax's
    ``param_dtype``) and the compute bf16 (its ``dtype``). ``apply`` takes
    NHWC images as ``module.apply`` does and gives fp32 logits; it computes
    what :class:`DenseNetish` computes (the served module keeps frozen bf16
    weights), and it runs over leaves that ``parallel.shard_params`` split
    over ``model`` (:class:`Sharded` by output channels)."""

    def __init__(self, num_classes: int, width: int = 32, stages: Sequence[int] = (2, 2, 2)):
        self.num_classes = num_classes
        self.width = width
        self.stages = tuple(stages)

    def init(self, seed: int, images: torch.Tensor) -> Dict[str, Any]:
        """:func:`draw_params` with ``seed`` as fp32 leaves on ``images``'
        device that require grad (flax's init reads shapes from ``images``;
        these shapes do not depend on them)."""
        return params_to_torch(draw_params(self.num_classes, self.width, self.stages, seed),
                               images.device)

    def apply(self, params: Mapping[str, Any], images: torch.Tensor) -> torch.Tensor:
        tree = params.get("params", params)
        x = _conv(images.to(torch.bfloat16).permute(0, 3, 1, 2), tree["Conv_0"]["kernel"], 2)
        x = F.max_pool2d(_pad_same(x, 3, 2, float("-inf")), 3, stride=2)
        for i, layers in enumerate(self.stages):
            stage = tree[f"DenseStage_{i}"]
            for j in range(layers):
                x = torch.cat([x, _conv_block(x, stage[f"ConvBlock_{j}"])], dim=1)
            x = F.avg_pool2d(_conv_block(x, tree[f"ConvBlock_{i}"]), 2, stride=2)
        x = x.float().mean(dim=(2, 3)).to(torch.bfloat16)  # global average pool
        dense = tree["Dense_0"]
        y = _apply_out(lambda x, k: x @ k.to(torch.bfloat16), x, dense["kernel"])
        return (y + dense["bias"].to(torch.bfloat16)).float()


def params_to_torch(params: Mapping[str, Any], device="cuda",
                    requires_grad: bool = True) -> Dict[str, Any]:
    """A flax param tree with numpy leaves (the port's :func:`draw_params`,
    or JAX's ``module.init`` tree exported with ``np.asarray``) as fp32
    torch leaves on ``device``, in :class:`FunctionalDenseNet`'s layout
    (which is flax's: nothing is transposed)."""
    def convert(value):
        if isinstance(value, Mapping):
            return {k: convert(v) for k, v in value.items()}
        t = torch.from_numpy(np.array(value, dtype=np.float32)).to(device)
        return t.requires_grad_(requires_grad)

    return convert(params)


class ImagePreprocessModel(Model):
    """``preprocess``: raw UINT8 HWC image -> normalised FP32 CHW [3,224,224].

    The ensemble's front stage: nearest resize, INCEPTION scaling through
    the normalize kernel, CHW layout. The output stays a tensor on the
    model's device, so an ensemble hands it to the next stage without a
    host copy."""

    name = "preprocess"

    def __init__(self, device="cuda"):
        super().__init__()
        self._device = torch.device(device)

    def inputs(self) -> List[TensorSpec]:
        return [TensorSpec("raw_image", "UINT8", [-1, -1, 3])]

    def outputs(self) -> List[TensorSpec]:
        return [TensorSpec("preprocessed", "FP32", [3, 224, 224])]

    def execute(self, inputs: Dict[str, Any], parameters: Dict[str, Any]):
        img = as_device_tensor(inputs["raw_image"], self._device)
        return {"preprocessed": preprocess_image(img, 224, 224, scale=2.0 / 255.0, shift=-1.0)}


class DenseNetModel(Model):
    """``densenet_onnx``: FP32 CHW image -> FP32 logits [num_classes,1,1]."""

    name = "densenet_onnx"
    platform = "pytorch_densenet"
    max_batch_size = 0  # fixture contract: one CHW image per request

    # stage depths: "lite" is the default; "121" the densenet-121 layout
    ARCHS = {"lite": (2, 2, 2), "121": (6, 12, 24, 16)}

    def __init__(self, num_classes: int = 1000, width: int = 32, seed: int = 0,
                 tensor_parallel: int = 1, arch: str = "lite", device="cuda",
                 mesh: Optional[Mesh] = None):
        """Weights come from :func:`draw_params` with ``seed`` until
        :func:`load_jax_params` replaces them. ``tensor_parallel > 1`` splits
        the output channels over the ``model`` axis of a (1, tp) mesh,
        ``tp = min(tensor_parallel, len(local_devices(device)))`` as JAX's;
        ``mesh`` gives that mesh instead (:meth:`DenseNetish.shard`)."""
        super().__init__()
        if arch not in self.ARCHS:
            raise ValueError(f"arch must be one of {sorted(self.ARCHS)}")
        if mesh is None and tensor_parallel > 1:
            devices = local_devices(device)
            tp = min(tensor_parallel, len(devices))
            mesh = Mesh([devices[:tp]], ("data", "model")) if tp > 1 else None
        self.mesh = mesh
        self._num_classes = num_classes
        self._width = width
        self._stages = self.ARCHS[arch]
        self._device = (torch.device(device) if self.mesh is None
                        else self.mesh.axis_devices("model")[0])
        self.net = DenseNetish(num_classes, width, self._stages, self._device)
        self._params = draw_params(num_classes, width, self._stages, seed)
        self.net.load(self._params)
        if self.mesh is not None:
            self.net.shard(self.mesh)
        self._labels = [f"class_{i}" for i in range(num_classes)]

    @property
    def tp_degree(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape["model"]

    @property
    def mesh_degrees(self) -> Dict[str, int]:
        """Also at tp = 1, so that a served ``--tensor-parallel`` shows the
        degree it chose."""
        return {"data": 1, "model": self.tp_degree}

    def inputs(self) -> List[TensorSpec]:
        return [TensorSpec("data_0", "FP32", [3, 224, 224])]

    def outputs(self) -> List[TensorSpec]:
        return [TensorSpec("fc6_1", "FP32", [self._num_classes, 1, 1])]

    def labels(self) -> Optional[List[str]]:
        return self._labels

    def forward_fn(self):
        """``(fn, params)`` for direct embedding, as JAX's: ``fn(params,
        chw_batch)`` takes the wire's CHW fp32 batch [N, 3, H, W] to fp32
        logits [N, num_classes] through :class:`FunctionalDenseNet`;
        ``params`` is the model's weights as fp32 leaves on its device, split
        over its mesh's ``model`` axis when it has one."""
        module = FunctionalDenseNet(self._num_classes, self._width, self._stages)
        params = params_to_torch(self._params, self._device, requires_grad=False)
        if self.mesh is not None:
            params = shard_params(params, self.mesh)

        def fn(params, chw_batch: torch.Tensor) -> torch.Tensor:
            return module.apply(params, chw_batch.permute(0, 2, 3, 1))

        return fn, params

    def execute(self, inputs: Dict[str, Any], parameters: Dict[str, Any]):
        # a cuda shared-memory input (or an ensemble's device tensor) is used
        # in place; a host array goes to the device once
        x = as_device_tensor(inputs["data_0"], self._device)
        logits = self.net(x.reshape((1, 3) + tuple(x.shape[-2:])))
        # the output stays a device tensor (pinned in a cuda shm region, or
        # brought to the host when the response is encoded)
        return {"fc6_1": logits.reshape(self._num_classes, 1, 1)}


def load_jax_params(model: DenseNetModel, params: Mapping[str, Any]) -> None:
    """Copy the flax param tree (``{"params": {...}}`` with numpy leaves,
    e.g. ``jax.tree_util.tree_map(np.asarray, DenseNetModel(...).forward_fn()[1])``
    of the JAX package) into ``model``; :meth:`DenseNetModel.forward_fn`
    then gives them too."""
    model.net.load(params)
    model._params = params
