"""Shared fixtures of the tests/test_torch_port_*.py files: the narrow
EELUnet that the JAX package and the PyTorch port are compared on, and
paired train steps of the two packages from the same weights."""

from __future__ import annotations

import dataclasses
import fcntl
import os
import traceback
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from eelunet_tpu.config import LossConfig as JaxLossConfig
from eelunet_tpu.config import OptimizerConfig as JaxOptimizerConfig
from eelunet_tpu.models.eelunet import EELUnet as JaxEELUnet
from eelunet_tpu.models.torch_port import port_state_dict
from eelunet_tpu.registry import MODEL_REGISTRY as JAX_MODEL_REGISTRY
from eelunet_tpu.train import trainer as jax_trainer
from eelunet_tpu.train.state import TrainState as JaxTrainState
from eelunet_tpu.train.state import build_optimizer as jax_build_optimizer
from eelunet_tpu_torch.config import LossConfig, ModelConfig, OptimizerConfig
from eelunet_tpu_torch.inference import random_state_dict
from eelunet_tpu_torch.models.convert import from_flax_variables, to_upstream_state_dict
from eelunet_tpu_torch.ops import fft_cuda
from eelunet_tpu_torch.registry import MODEL_REGISTRY, create_model
from eelunet_tpu_torch.train.state import TrainState, build_optimizer
from eelunet_tpu_torch.train.trainer import make_loss_fn, make_train_step

# Under pytest-xdist the workers share the host's cores. torch sizes its
# OpenMP pool to the whole host in each of them, and oversubscribed OpenMP
# threads spin at every barrier: six workers of 8 threads on 8 cores ran a
# small model's steps about 100x slower than with one thread each. So each
# worker, and each process it starts, takes its share of the cores.
_XDIST_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _XDIST_WORKERS > 1:
    _SHARE = max(1, len(os.sched_getaffinity(0)) // _XDIST_WORKERS)
    torch.set_num_threads(_SHARE)
    os.environ.setdefault("OMP_NUM_THREADS", str(_SHARE))

# Channel widths of the narrow test model (the JAX EELUnet's ``widths`` groups).
NARROW = tuple(sorted({
    "e1": 8, "e1a": 8, "e2": 16, "e2a": 16, "e3": 16, "e3a": 16, "e4": 32, "e4a": 32,
    "bna": 32, "bot": 32,
    "eu4ct": 16, "eu4": 16, "ec4a": 16, "d4sum": 32,
    "eu3ct": 16, "eu3": 16, "ec3a": 16, "d3sum": 16,
    "eu2": 16, "ec2a": 16, "d2sum": 16, "eu1": 8, "ec1a": 8, "d1sum": 8,
    "u4ct": 16, "d4": 32, "d4a": 32, "u3ct": 16, "d3": 16, "d3a": 16,
    "d2": 16, "d2a": 16, "d1a": 8,
}.items()))
# At the default 20 the 32x32 high-pass site would have 2m >= H, and the mask
# would zero the whole spectrum.
MASK_RANGE = 6
CFG = ModelConfig(name="eelunet", fft_mask_range=MASK_RANGE)
LR = 1e-4
STEPS = 3


def narrow_flax_variables(seed: int = 0, in_channels: int = 3, out_channels: int = 1):
    """Flax variables (numpy trees) of the narrow EELUnet: PyTorch's default
    init from a seeded generator, BN statistics and affines randomised (the
    identity-like init would hide a broken fold or a mis-mapped statistic),
    imported through the JAX package's own upstream-layout importer. No JAX
    tracing is needed to make them."""
    cfg = dataclasses.replace(CFG, in_channels=in_channels, out_channels=out_channels)
    sd = random_state_dict(cfg, seed=seed, widths=NARROW)
    rng = np.random.default_rng(seed)
    for k, v in sd.items():
        if k.endswith((".running_var", ".weight")) and k.rpartition(".")[0].endswith(
                ("bn0", "bn1", "bottleneck_bn")):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.8, v.shape).astype(np.float32))
        elif k.endswith((".running_mean", ".bias")) and k.rpartition(".")[0].endswith(
                ("bn0", "bn1", "bottleneck_bn")):
            sd[k] = torch.from_numpy((rng.standard_normal(v.shape) * 0.3).astype(np.float32))
    return port_state_dict("eelunet", to_upstream_state_dict(sd))


def narrow_input(seed: int = 0, batch: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((batch, 64, 64, 3)).astype(np.float32)


def port_state(sd, cfg=CFG, lr=LR, spe=STEPS, dtype=torch.float32) -> TrainState:
    """A port TrainState of the narrow EELUnet holding ``sd``, Adam at ``lr``."""
    model, _ = create_model(cfg, widths=NARROW)
    model = model.to(dtype=dtype, memory_format=torch.channels_last)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    opt, sched = build_optimizer(OptimizerConfig(lr=lr), model.parameters(), spe)
    return TrainState(model, opt, sched, seed=0)


def edge_loss_fn(loss_name: str = "edge_bce_dice"):
    return make_loss_fn(loss_name, LossConfig(), MODEL_REGISTRY["eelunet"])


def port_index(variables):
    """Where each element of each port tensor lies in the JAX ``variables``
    leaves, concatenated in tree order. ``from_flax_variables`` moves
    elements and computes none, so applied to a tree of element numbers it
    gives a map that takes any tree of that structure over exactly, in any
    dtype (it converts through float32, exact for element numbers < 2**24)."""
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    start = np.cumsum([0] + [np.size(leaf) for leaf in leaves])
    assert start[-1] < 2 ** 24
    numbered = treedef.unflatten([np.arange(a, a + np.size(leaf)).reshape(np.shape(leaf))
                                  for a, leaf in zip(start, leaves)])
    return {k: v.long().numpy() for k, v in from_flax_variables(numbered).items()
            if v.is_floating_point()}


def port_tree(variables, index):
    flat = np.concatenate([np.ravel(np.asarray(leaf))
                           for leaf in jax.tree_util.tree_leaves(variables)])
    return {k: torch.from_numpy(flat[ix]) for k, ix in index.items()}


def paired_train_steps(variables, batches, float64: bool, cfg=CFG,
                       loss_name: str = "edge_bce_dice"):
    """Paired train steps from the same narrow weights, one per batch, in
    float32 or float64: the JAX step on its low-rank high-pass, the port's
    step on the high-pass Function (plain twins on the CPU). ``batches``
    holds (JAX model input, port model input, labels) numpy triples, so each
    package may feed its own input chain's output. Also the first step's
    gradients: the port's ``.grad``, and JAX's from its Adam first moment
    after one step, (1 - b1) (g + wd p). ``loss_name`` is the criterion of
    both steps; ``cfg.out_channels`` the model's head."""
    index = port_index(variables)
    steps = len(batches)
    wd = OptimizerConfig().weight_decay
    with jax.enable_x64(float64):
        jdt = jnp.float64 if float64 else jnp.float32
        model = JaxEELUnet(mask_range=MASK_RANGE, widths=NARROW, highpass_impl="lowrank",
                           out_channels=cfg.out_channels,
                           **({"dtype": jdt} if float64 else {}))
        loss_fn = jax_trainer.make_loss_fn(loss_name, JaxLossConfig(),
                                           JAX_MODEL_REGISTRY["eelunet"])
        step = jax_trainer.make_train_step(model, loss_fn, True, donate=False)
        tx = jax_build_optimizer(JaxOptimizerConfig(lr=LR), steps)
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), t)  # noqa: E731
        params = cast(variables["params"])
        jstate = JaxTrainState(params=params, batch_stats=cast(variables["batch_stats"]),
                               opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
                               rng=jax.random.PRNGKey(0), tx=tx)
        loss_j = []
        for i, (x, _, y) in enumerate(batches):
            jstate, loss, _ = step(jstate, jnp.asarray(x, jdt), jnp.asarray(y, jdt))
            loss_j.append(float(loss))
            if i == 0:
                mu1 = next(s.mu for s in jstate.opt_state if hasattr(s, "mu"))
                mu1 = port_tree({"params": jax.device_get(mu1),
                                 "batch_stats": variables["batch_stats"]}, index)
        want = port_tree({"params": jax.device_get(jstate.params),
                          "batch_stats": jax.device_get(jstate.batch_stats)}, index)

    tdt = torch.float64 if float64 else torch.float32
    init = {k: v.to(tdt) for k, v in port_tree(variables, index).items()}
    pstate = port_state(init, cfg, spe=steps, dtype=tdt)
    pstep = make_train_step(edge_loss_fn(loss_name))
    loss_t = []
    for i, (_, x, y) in enumerate(batches):
        loss, ok = pstep(pstate, torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt))
        assert ok
        loss_t.append(float(loss))
        if i == 0:
            grad_t = {k: p.grad.clone() for k, p in pstate.model.named_parameters()}
    grad_j = {k: mu1[k].to(tdt) / 0.1 - wd * init[k] for k in grad_t}
    # the model and step count of the port's state (its schedule does not
    # pickle, and once_per_run caches the result)
    pstate = types.SimpleNamespace(model=pstate.model, step=pstate.step)
    return {"loss_j": np.array(loss_j), "loss_t": np.array(loss_t), "want": want,
            "pstate": pstate, "init": init, "grad_j": grad_j, "grad_t": grad_t}


# ------------------------------------------ the tensor-core kernels' arithmetic

def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 (10 mantissa bits), round to nearest even, kept as
    float32 with the low 13 bits zero; infinities and NaNs pass through.
    The rounding kernel 4 applies to A and R before its TF32 products
    (``to_tf32`` in ``csrc/highpass_bwd.cu``)."""
    bits = t.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    finite = (bits & 0x7F800000) != 0x7F800000
    rounded = (bits + 0xFFF + ((bits >> 13) & 1)) & 0xFFFFE000
    out = torch.where(finite, rounded, bits)
    out = torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)
    return out.view(torch.float32).view(t.shape)


def stacked_factors(vr_t: torch.Tensor, vi_t: torch.Tensor):
    """The operands the tensor-core kernels read through two pointers each:
    kernel 1's stacked V_H^T = [V_r^T | V_i^T] and kernel 4's
    A = [V_r^T | -V_i^T], both (H, 2K)."""
    return torch.cat([vr_t, vi_t], dim=1), torch.cat([vr_t, -vi_t], dim=1)


def contract_tc_emulated(x3: torch.Tensor, vr_t: torch.Tensor, vi_t: torch.Tensor):
    """Kernel 1's arithmetic on the tensor cores: one product of the stacked
    V_H (2K, H) and x (H, W*C) per image, bf16 operands (exact products in
    f32), f32 sums; split into (T_r, T_i)."""
    v_stack, _ = stacked_factors(vr_t, vi_t)
    t = torch.einsum("hk,bhj->bkj", v_stack.float(), x3.float())
    k = vr_t.shape[1]
    return t[:, :k].contiguous(), t[:, k:].contiguous()


def bwd_expand_tf32_emulated(u_re, vr_t, vi_t, rr, ri):
    """Kernel 4's arithmetic in a bf16 model: A and R rounded to TF32, the
    products summed in f32, subtracted from f32(u), rounded to u's type."""
    _, a = stacked_factors(vr_t, vi_t)
    r = torch.cat([rr, ri], dim=1)
    adj = torch.einsum("hk,bkj->bhj", round_tf32(a), round_tf32(r))
    return (u_re.float() - adj).to(u_re.dtype)


def ue_pieces(ue: torch.Tensor, h: int):
    """Decode kernels 2 and 3's stacked operand Ue (``fft_cuda.uh_stacked``)
    into the float32 bf16 pieces of A_re = [U_r | -U_i] and of
    A_im = [U_i | U_r], each (H, 2K): ((re_0, re_1, re_2), (im_0, im_1, im_2))."""
    k2 = ue.shape[1] // 3
    grp = ue.float().view(-1, 2, 8, 3 * k2)
    re = grp[:, 0].reshape(-1, 3 * k2)[:h]
    im = grp[:, 1].reshape(-1, 3 * k2)[:h]
    return tuple(tuple(a[:, p * k2:(p + 1) * k2] for p in range(3)) for a in (re, im))


# The products of each split arithmetic, (piece of a, piece of b), as the
# kernels take them (csrc/tc_bf16.cuh).
BF16X3 = ((0, 0), (0, 1), (1, 0))
BF16X6 = BF16X3 + ((0, 2), (2, 0), (1, 1))


def _split_product(a, b, spec: str, terms):
    """Sum of the chosen piece products, each exact in f32, summed in f32;
    a and b are tuples of float32 pieces."""
    return sum(torch.einsum(spec, a[i], b[j]) for i, j in terms)


def _pieces(t: torch.Tensor, n: int):
    return tuple(v.float() for v in fft_cuda.bf16_split(t, n))


def _rebuild_split(ur, ui, sr, si, terms):
    """(lr, li) = U_H S as kernels 2 (bf16x3) and 3 (bf16x6) take it on the
    tensor cores: the stacked Ue against [S_r; S_i] split in registers."""
    a_re, a_im = ue_pieces(fft_cuda.uh_stacked(ur, ui), ur.shape[0])
    s = _pieces(torch.cat([sr, si], 1), 3)
    return (_split_product(a_re, s, "hk,bkj->bhj", terms),
            _split_product(a_im, s, "hk,bkj->bhj", terms))


def expand_bf16x3_emulated(x3, ur, ui, sr, si):
    """Kernel 2's arithmetic in a bf16 model (``expand_kernel_tc``): the
    rebuild in bf16x3, then sqrt(max((x - lr)^2 + li^2, 1e-24)) in f32,
    rounded to x's type."""
    lr, li = _rebuild_split(ur, ui, sr, si, BF16X3)
    zr = x3.float() - lr
    return torch.sqrt(torch.clamp(zr * zr + li * li, min=1e-24)).to(x3.dtype)


def expand_tf32_emulated(x3, ur, ui, sr, si):
    """Kernel 2 in one pass of TF32 (A and S rounded to TF32, f32 sums): the
    arithmetic the kernel does not take, kept to show why."""
    a_re, a_im = (round_tf32(torch.cat(p, 1)) for p in ((ur, -ui), (ui, ur)))
    s = round_tf32(torch.cat([sr, si], 1))
    lr, li = (torch.einsum("hk,bkj->bhj", a, s) for a in (a_re, a_im))
    zr = x3.float() - lr
    return torch.sqrt(torch.clamp(zr * zr + li * li, min=1e-24)).to(x3.dtype)


def bwd_contract_split_emulated(x3, g3, ur, ui, sr, si, rebuild_terms=BF16X6):
    """Kernel 3's arithmetic in a bf16 model (``bwd_contract_kernel_tc``):
    the rebuild in bf16x6 (``rebuild_terms``; bf16x3 to show why not);
    u = g z/|z| (0 below the floor) in f32; Re u in x's type;
    T' = Ue^T [u_r; u_i] in bf16x3 from u's two pieces, so T_r = T'[:K] and
    T_i = -T'[K:]."""
    lr, li = _rebuild_split(ur, ui, sr, si, rebuild_terms)
    zr = x3.float() - lr
    zi = -li
    sq = zr * zr + zi * zi
    coef = torch.where(sq >= 1e-24, g3.float() / torch.sqrt(torch.clamp(sq, min=1e-24)), 0.0)
    u_r, u_i = coef * zr, coef * zi
    a_re, a_im = ue_pieces(fft_cuda.uh_stacked(ur, ui), ur.shape[0])
    t = (_split_product(a_re, _pieces(u_r, 2), "hk,bhj->bkj", BF16X3)
         + _split_product(a_im, _pieces(u_i, 2), "hk,bhj->bkj", BF16X3))
    k = ur.shape[1]
    return u_r.to(x3.dtype), t[:, :k].contiguous(), (-t[:, k:]).contiguous()


# ------------------------------------------------ kernel 6 on the tensor cores

def conv3x3_split_emulated(x, w, scale=None, shift=None, relu=False, terms=BF16X6):
    """Kernel 6's float32 arithmetic (``conv3x3_kernel_tc<float, 3>``): x
    and w split into bf16 pieces (``fft_cuda.bf16_split``), the chosen piece
    products (bf16x6; bf16x3 to show why not) each exact in f32 and summed
    in f32 (a library conv of the pieces), then ``acc * scale + shift``
    rounded each, and ReLU. NHWC x, HWIO w; float32 out."""
    n = 1 + max(max(t) for t in terms)
    xp = _pieces(x, n)
    wp = _pieces(w, n)
    acc = sum(F.conv2d(xp[i].permute(0, 3, 1, 2), wp[j].permute(3, 2, 0, 1), padding=1)
              for i, j in terms).permute(0, 2, 3, 1)
    cout = w.shape[3]
    if scale is not None:
        acc = acc * scale.float().view(1, 1, 1, cout)
    if shift is not None:
        acc = acc + shift.float().view(1, 1, 1, cout)
    return torch.clamp_min(acc, 0.0) if relu else acc


# ------------------------------------------------------- the hysteresis kernel

HYST_TILE = 32  # csrc/canny.cu kHT
OFF, WEAK, ON = 0, 1, 2


def _relax(tiles: torch.Tensor):
    """A batch of (T+2, T+2) uint8 tiles with their halo grown to the local
    fixpoint: weak -> on where a neighbour is on, inside the halo only.
    Returns (the tiles, which of them changed)."""
    t = tiles.clone()
    inner = torch.zeros(t.shape[1:], dtype=torch.bool)
    inner[1:-1, 1:-1] = True
    while True:
        near = F.max_pool2d((t == ON).float()[:, None], 3, stride=1, padding=1)[:, 0] > 0
        grow = (t == WEAK) & near & inner
        if not grow.any():
            break
        t[grow] = ON
    return t, (t != tiles).flatten(1).any(1)


def hysteresis_tiled_emulated(nms: torch.Tensor, low: float, high: float,
                              schedule: str = "snapshot"):
    """The hysteresis kernel's algorithm (``hysteresis_kernel`` in
    ``csrc/canny.cu``) on an (N,H,W,1) NMS magnitude: a uint8 state (2 on:
    nms >= high; 1 weak: low <= nms < high; 0 off), then rounds over
    HYST_TILE-square tiles, each loaded with a 1-pixel halo, grown to its
    local fixpoint and written back, until a round changes nothing.
    ``snapshot``: every tile reads the state its round began with, the
    slowest schedule the card's blocks can take; ``in_order``: tiles one
    after another, each reading what the earlier ones wrote, as a block
    does that reads a neighbour already written this round. Returns (the
    {0, 1} float32 map, the rounds run)."""
    m = nms[..., 0].float()
    state = torch.where(m >= high, ON, torch.where(m >= low, WEAK, OFF)).to(torch.uint8)
    n, h, w = state.shape
    t = HYST_TILE
    th, tw = -(-h // t), -(-w // t)
    canvas = torch.zeros((n, th * t + 2, tw * t + 2), dtype=torch.uint8)  # zero halo
    canvas[:, 1:h + 1, 1:w + 1] = state
    rounds = 0
    while True:
        rounds += 1
        if schedule == "snapshot":
            tiles = canvas.unfold(1, t + 2, t).unfold(2, t + 2, t).reshape(-1, t + 2, t + 2)
            grown, changed = _relax(tiles)
            inner = grown[:, 1:-1, 1:-1].reshape(n, th, tw, t, t).permute(0, 1, 3, 2, 4)
            canvas[:, 1:-1, 1:-1] = inner.reshape(n, th * t, tw * t)
            changed = bool(changed.any())
        elif schedule == "in_order":
            changed = False
            for b in range(n):
                for i in range(th):
                    for j in range(tw):
                        win = canvas[b, i * t:i * t + t + 2, j * t:j * t + t + 2]
                        grown, ch = _relax(win[None])
                        if bool(ch[0]):
                            win[1:-1, 1:-1] = grown[0, 1:-1, 1:-1]
                            changed = True
        else:
            raise ValueError(schedule)
        if not changed:
            break
    return (canvas[:, 1:h + 1, 1:w + 1] == ON).float()[..., None], rounds


def serpentine(h: int, w: int, pitch: int = 4) -> np.ndarray:
    """A (1,H,W,1) NMS-like map: a weak path (0.5) that winds along every
    ``pitch``-th row and down alternate ends, across many 32x32 tiles, with
    one strong pixel (1.0) at its start; 0 elsewhere."""
    m = np.zeros((h, w), np.float32)
    rows = list(range(1, h - 1, pitch))
    for k, r in enumerate(rows):
        m[r, 1:w - 1] = 0.5
        if k + 1 < len(rows):
            c = w - 2 if k % 2 == 0 else 1
            m[r:rows[k + 1] + 1, c] = 0.5
    m[rows[0], 1] = 1.0
    return m[None, :, :, None]


def once_per_run(tmp_path_factory, name: str, make):
    """``make(workdir)``, computed once per test run however many xdist
    workers ask for it (pytest-xdist's "execute once" pattern): a
    ``scope="module"`` fixture runs again on every worker that receives a
    test of its file under ``--dist load``. The first worker computes it
    under an exclusive ``fcntl.flock`` on a file in the directory that the
    workers' temp dirs share, and caches the result there (``torch.save``;
    a failure is cached as its traceback); the others wait on the lock and
    load it. Without xdist it is ``make`` in a fresh temp dir."""
    if os.environ.get("PYTEST_XDIST_WORKER") is None:
        return make(str(tmp_path_factory.mktemp(name)))
    root = tmp_path_factory.getbasetemp().parent
    cache = root / f"{name}.pt"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not cache.exists():
            work = root / name
            work.mkdir(exist_ok=True)
            try:
                out = {"result": make(str(work))}
            except Exception:
                out = {"error": traceback.format_exc()}
            torch.save(out, cache)
        out = torch.load(cache, weights_only=False)
    if "error" in out:
        raise RuntimeError(f"{name} failed (computed once for the run):\n{out['error']}")
    return out["result"]
