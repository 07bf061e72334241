"""Shared fixtures of tests/test_torch_port_predict*.py: UNeXt-S at its
published width (0.25 M parameters), binary or 3-class, with the same
weights as a JAX checkpoint and as the port's upstream-layout .npz, and a
PNG tree to predict on. The JAX CLI predicts with the unfolded model, the
port's with BN folded (``bnfold.py``, within 2e-5), so a mask may differ
where a probability lies at the threshold: such pixels are ties."""

from __future__ import annotations

import numpy as np
import torch

from eelunet_tpu.config import TrainConfig as JaxTrainConfig
from eelunet_tpu.config import apply_overrides as jax_apply_overrides
from eelunet_tpu.data.dataset import SegmentationFolderDataset as JaxFolderDataset
from eelunet_tpu.models.torch_port import port_state_dict
from eelunet_tpu.parallel.mesh import create_mesh
from eelunet_tpu.train.trainer import Trainer as JaxTrainer
from eelunet_tpu_torch.config import ModelConfig
from eelunet_tpu_torch.data.synthetic import write_synthetic_tree
from eelunet_tpu_torch.models.convert import from_flax_variables, to_upstream_state_dict
from eelunet_tpu_torch.nn.layers import init_weights
from eelunet_tpu_torch.registry import create_model
from torch_port_families import randomise_constants

NAME = "unext_s"
SIZE, NATIVE = 32, (40, 56)  # the resize target; the tree's own image size
TILE, OVERLAP = 32, 8
TIE = 1e-4  # a JAX probability this close to the threshold (or to the runner-up) is a tie
MAX_TIES = 1e-3  # share of pixels where the masks may differ, at ties only
PROB_TOL = 5e-4  # the families' forward bound (test_torch_port_families_forward.py)


def _variables(classes: int, images: np.ndarray, seed: int = 0):
    """Flax variables of UNeXt-S with ``classes`` outputs, from the port's
    seeded init with its constants randomised, through the JAX package's
    upstream importer. The head's bias is moved so that each class's logit
    is centred (binary: its median is 0) on ``images``, uint8 NHWC: random
    weights would otherwise paint one class over every pixel."""
    model, _ = create_model(ModelConfig(name=NAME, out_channels=classes))
    sd = randomise_constants(init_weights(model, torch.Generator().manual_seed(seed))
                             .state_dict(), seed)
    model.load_state_dict(sd)
    x = (torch.from_numpy(images).float() / 255 - torch.tensor([0.485, 0.456, 0.406])) \
        / torch.tensor([0.229, 0.224, 0.225])
    with torch.no_grad():
        logits = model.eval()(x.permute(0, 3, 1, 2)).seg.transpose(0, 1).reshape(classes, -1)
    sd["final.bias"] = sd["final.bias"] - (logits.median(1).values if classes == 1
                                           else logits.mean(1))
    return port_state_dict(NAME, to_upstream_state_dict(sd, NAME))


def predict_setup(classes: int, root):
    """The tree, the JAX checkpoint (weights-only tag) and the port's
    upstream-layout .npz of the same weights, for one class count, under
    ``root``."""
    tree = write_synthetic_tree(str(root / "tree"), n_train=1, n_test=5, image_size=NATIVE,
                                seed=classes, num_classes=classes)
    ds = JaxFolderDataset(tree, "test", (SIZE, SIZE), as_uint8=True)
    variables = _variables(classes, np.stack([ds[i][0] for i in range(len(ds))]))
    cfg = jax_apply_overrides(JaxTrainConfig(), [
        f"model.name={NAME}", f"model.out_channels={classes}", f"save_dir={root}/ck",
        "compile_cache="])
    trainer = JaxTrainer(cfg, mesh=create_mesh(1, 1))
    state = trainer.init_state().replace(params=variables["params"],
                                         batch_stats=variables["batch_stats"])
    jax_ckpt = trainer.ckpt.save_weights_tags(["best"], state)[0]
    npz = str(root / "port.npz")
    np.savez(npz, **to_upstream_state_dict(from_flax_variables(variables, NAME), NAME))
    return {"classes": classes, "root": root, "tree": tree, "jax_ckpt": jax_ckpt, "npz": npz}


def ties(probs, threshold=0.5):
    """Pixels where the JAX probability is a tie for the mask: within TIE of
    the threshold (binary) or of the runner-up class."""
    if probs.shape[-1] == 1:
        return np.abs(probs[..., 0] - threshold) < TIE
    top2 = np.sort(probs, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) < TIE


