"""SSL evaluation protocols on frozen backbone features (port of
pope_tpu/train/ssl_eval.py): k-NN classification, the linear probe and the
log-regression sweep.

The optimizers are torch.optim's AdamW (the linear probe) and SGD with
momentum (log regression), whose updates are optax's to rounding, so that
the same features, labels and batch indices give the JAX package's
classifiers. `top_k` ties go to the lower index, as `jax.lax.top_k`'s do
(a stable descending sort).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


@torch.no_grad()
def extract_cls_features(backbone, images, batch_size: int = 64) -> torch.Tensor:
    """L2-normalized [cls] features of a frozen backbone, on its device.
    images: (N, H, W, 3) f32, numpy or a tensor; they go to the backbone's
    device `batch_size` at a time."""
    dev = next(backbone.parameters()).device
    images = torch.as_tensor(images)
    outs = [backbone(images[i:i + batch_size].to(dev, torch.float32))["x_norm_clstoken"]
            for i in range(0, images.shape[0], batch_size)]
    feats = torch.cat(outs, 0)
    return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True).clamp(min=1e-12)


def _num_classes(labels, num_classes):
    return num_classes or int(labels.max()) + 1


def knn_classify(train_feats, train_labels, test_feats, nb_knn: Sequence[int] = (10, 20, 100, 200),
                 T: float = 0.07, num_classes: Optional[int] = None) -> Dict[int, torch.Tensor]:
    """{k: (N_test, num_classes) class probabilities} for each k in nb_knn:
    a softmax(sims / T)-weighted vote of the max(nb_knn) most similar
    training features (cosine; the features must be L2-normalized)."""
    num_classes = _num_classes(train_labels, num_classes)
    max_k = max(nb_knn)
    sims = test_feats @ train_feats.T
    topk_sims, idx = torch.sort(sims, dim=-1, descending=True, stable=True)
    topk_sims, idx = topk_sims[:, :max_k], idx[:, :max_k]
    neighbor_labels = train_labels[idx]  # (N, max_k)
    w = torch.softmax(topk_sims / T, dim=-1)[..., None]
    votes = F.one_hot(neighbor_labels.long(), num_classes).to(w.dtype) * w  # (N, max_k, C)
    return {k: votes[:, :k, :].sum(dim=1) for k in nb_knn}


def knn_accuracy(train_feats, train_labels, test_feats, test_labels, nb_knn: Sequence[int] = (10, 20, 100, 200),
                 T: float = 0.07, num_classes: Optional[int] = None) -> Dict[int, float]:
    probas = knn_classify(train_feats, train_labels, test_feats, nb_knn, T, num_classes)
    return {k: float((p.argmax(-1) == test_labels).float().mean()) for k, p in probas.items()}


def _softmax_ce(logits, labels):
    """optax.softmax_cross_entropy_with_integer_labels, meaned."""
    return -(torch.log_softmax(logits, dim=-1).gather(-1, labels.long()[:, None])[:, 0]).mean()


def _zero_leaves(D: int, C: int, device):
    """The probe's {"w": (D, C), "b": (C,)}, zeros that take gradients."""
    return {"w": torch.zeros(D, C, device=device, requires_grad=True),
            "b": torch.zeros(C, device=device, requires_grad=True)}


def train_linear_probe(train_feats, train_labels, num_classes: Optional[int] = None, lr: float = 1e-2,
                       weight_decay: float = 0.0, steps: int = 500, batch_size: int = 256, seed: int = 0,
                       indices=None):
    """Multinomial logistic regression on frozen features, trained by
    torch.optim.AdamW (optax.adamw's update to rounding) on random batches.
    `indices` (steps, B) gives each step's batch; else they are drawn from a
    CPU generator seeded with `seed`. Returns ({"w": (D, C), "b": (C,)},
    per-step losses as numpy)."""
    num_classes = _num_classes(train_labels, num_classes)
    N, D = train_feats.shape
    dev = train_feats.device
    if indices is None:
        indices = torch.randint(0, N, (steps, min(batch_size, N)), generator=torch.Generator().manual_seed(seed))
    indices = torch.as_tensor(np.asarray(indices)).to(dev)
    params = _zero_leaves(D, num_classes, dev)
    opt = torch.optim.AdamW(params.values(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    losses = []
    for idx in indices:
        loss = _softmax_ce(train_feats[idx] @ params["w"] + params["b"], train_labels[idx])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    params = {k: v.detach() for k, v in params.items()}
    return params, torch.stack(losses).cpu().numpy() if losses else np.zeros((0,), np.float32)


def linear_probe_accuracy(params, feats, labels) -> float:
    logits = feats @ params["w"] + params["b"]
    return float((logits.argmax(-1) == labels).float().mean())


def _solve_log_regression(train_feats, train_labels, num_classes: int, l2: float, steps: int, lr: float):
    """Full-batch L2-regularized softmax regression by torch.optim.SGD with
    momentum 0.9 (optax.sgd(lr, momentum=0.9)'s update)."""
    N, D = train_feats.shape
    params = _zero_leaves(D, num_classes, train_feats.device)
    opt = torch.optim.SGD(params.values(), lr=lr, momentum=0.9)
    for _ in range(steps):
        loss = _softmax_ce(train_feats @ params["w"] + params["b"], train_labels) + l2 * (params["w"] ** 2).sum()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return {k: v.detach() for k, v in params.items()}


def log_regression_accuracy(train_feats, train_labels, val_feats, val_labels, test_feats=None, test_labels=None,
                            l2_values: Sequence[float] = tuple(10.0 ** e for e in range(-4, 3)),
                            steps: int = 400, lr: float = 0.5, num_classes: Optional[int] = None):
    """The log-regression protocol: one full-batch gradient-descent-with-
    momentum solve per regularization strength, the best on the validation
    split scored on the test split. Returns (best_test_acc, best_l2,
    {l2: val_acc})."""
    num_classes = _num_classes(train_labels, num_classes)
    if test_feats is None:
        test_feats, test_labels = val_feats, val_labels
    val_accs = {}
    best_l2, best_params, best_val = None, None, -1.0
    for l2 in l2_values:
        params = _solve_log_regression(train_feats, train_labels, num_classes, l2, steps, lr)
        acc = linear_probe_accuracy(params, val_feats, val_labels)
        val_accs[l2] = acc
        if acc > best_val:
            best_val, best_l2, best_params = acc, l2, params
    return linear_probe_accuracy(best_params, test_feats, test_labels), best_l2, val_accs
