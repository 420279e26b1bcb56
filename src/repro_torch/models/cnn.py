"""The paper's CNN (Section III-B / V-A): the model each vehicle trains on its
private MNIST shard.  conv(32,3x3)-relu-pool / conv(64,3x3)-relu-pool /
dense(128)-relu / dense(10), cross-entropy loss (Eq. 1), plain SGD (Eq. 2).

Parameters are a plain ``dict[str, Tensor]`` with ``repro.models.cnn``'s leaf
names and element order: convolution kernels in HWIO, ``fc1_w`` rows in
(h, w, c) order of the NHWC activation.  Images are NHWC.  The forward pass
permutes to PyTorch's OIHW / NCHW only internally, so weights, checkpoints
and flat buffers compare element for element with the JAX package.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# leaf -> shape of the 10-class model, in repro's layout
CNN_SHAPES = {
    "conv1_w": (3, 3, 1, 32),
    "conv1_b": (32,),
    "conv2_w": (3, 3, 32, 64),
    "conv2_b": (64,),
    "fc1_w": (7 * 7 * 64, 128),
    "fc1_b": (128,),
    "fc2_w": (128, 10),
    "fc2_b": (10,),
}


def init_cnn(generator: torch.Generator, *, device, num_classes: int = 10,
             dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Draws from the distributions of ``repro.models.cnn.init_cnn``
    (fan-in-scaled normals, zero biases).  ``generator`` is a CPU
    generator; the bits differ from ``jax.random``'s, so conformance runs
    take the JAX init through :func:`repro_torch.convert.params_from_jax`."""
    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator) / math.sqrt(fan_in)
        return w.to(device=device, dtype=dtype)

    def zeros(n):
        return torch.zeros((n,), device=device, dtype=dtype)

    return {
        "conv1_w": normal((3, 3, 1, 32), 3 * 3 * 1),
        "conv1_b": zeros(32),
        "conv2_w": normal((3, 3, 32, 64), 3 * 3 * 32),
        "conv2_b": zeros(64),
        "fc1_w": normal((7 * 7 * 64, 128), 7 * 7 * 64),
        "fc1_b": zeros(128),
        "fc2_w": normal((128, num_classes), 128),
        "fc2_b": zeros(num_classes),
    }


def _conv_same(x, w_hwio):
    """3x3 stride-1 "SAME" convolution of NCHW ``x`` by an HWIO kernel."""
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), padding=1)


def _max_pool_2x2(x):
    """2x2/stride-2 max pool of NCHW ``x`` via reshape + ``amax``.

    ``amax`` splits the gradient evenly among tied maxima, as JAX's max
    VJP does; ``F.max_pool2d`` would send all of it to one index."""
    b, c, h, w = x.shape
    return x.reshape(b, c, h // 2, 2, w // 2, 2).amax(dim=(3, 5))


def cnn_forward(params, images):
    """images: [B, 28, 28, 1] (NHWC) -> logits [B, num_classes]."""
    x = images.permute(0, 3, 1, 2)
    x = _conv_same(x, params["conv1_w"])
    x = _max_pool_2x2(F.relu(x + params["conv1_b"][:, None, None]))
    x = _conv_same(x, params["conv2_w"])
    x = _max_pool_2x2(F.relu(x + params["conv2_b"][:, None, None]))
    # back to NHWC before the flatten: fc1_w rows are in (h, w, c) order
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(x @ params["fc1_w"] + params["fc1_b"])
    return x @ params["fc2_w"] + params["fc2_b"]


def cross_entropy_loss(logits, labels):
    """Eq. (1): -sum_a y_a log(yhat_a), mean-reduced over the batch."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels[:, None].long())[:, 0]
    return nll.mean()


def accuracy(logits, labels):
    """Eq. (12)."""
    return (logits.argmax(-1) == labels).float().mean()


def sgd_train_step(params, images, labels, lr: float):
    """One local iteration: Eqs. (1)-(2).  Returns (new params, loss)."""
    def loss_fn(p):
        return cross_entropy_loss(cnn_forward(p, images), labels)

    grads, loss = torch.func.grad_and_value(loss_fn)(params)
    return {k: w - lr * grads[k] for k, w in params.items()}, loss
