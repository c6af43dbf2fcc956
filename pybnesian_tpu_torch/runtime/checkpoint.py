"""Checkpoint and resume with ``torch.save``.

Counterpart of ``pybnesian_tpu/runtime/checkpoint.py`` (orbax there). The
reference's only checkpointing is pickling the model each hill-climbing
iteration (learning/algorithms/callbacks/save_model.hpp:8-30) with no
resume logic. This module adds:

- :func:`save_pytree` / :func:`load_pytree`: a nested dict, list or tuple
  of tensors, numbers and numpy arrays in one file of a checkpoint
  directory, written under a temporary name, flushed to disk and renamed,
  so a save cut short leaves the last state whole;
- :func:`nuts_checkpointed`: a long NUTS run that persists (position,
  generator state, adapted step and mass, the blocks drawn so far) after
  every block, and resumes after a preemption from the last block.

Structure-search resume needs no new machinery: ``SaveModel`` writes the
model per iteration and ``hc(start=load(...))`` continues from it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["save_pytree", "load_pytree", "nuts_checkpointed"]

_FILE = "tree.pt"


def _storable(tree):
    """``tree`` with numpy arrays and scalars as tensors and every tensor
    detached on the CPU: what ``torch.load(weights_only=True)`` reads
    back."""
    if isinstance(tree, dict):
        return {k: _storable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_storable(v) for v in tree)
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree))
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def _like(tree, template):
    """``tree`` with each leaf given its ``template`` leaf's kind: a tensor
    the template tensor's dtype and device, a numpy array its dtype."""
    if isinstance(template, dict):
        return {k: _like(tree[k], v) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_like(a, b) for a, b in zip(tree, template))
    if isinstance(template, torch.Tensor):
        return tree.to(dtype=template.dtype, device=template.device)
    if isinstance(template, (np.ndarray, np.generic)):
        return np.asarray(tree.numpy(), dtype=template.dtype)
    return tree


def save_pytree(path: str, tree) -> None:
    """Write ``tree`` (nested dicts, lists and tuples of tensors, numbers
    and numpy arrays) into the directory ``path``, replacing what a
    previous save left there only once the new file is whole."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, _FILE)
    tmp = f"{final}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        torch.save(_storable(tree), f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)


def load_pytree(path: str, template=None):
    """Read a tree written by :func:`save_pytree`: tensors on the CPU
    (numpy arrays come back as tensors). ``template``, a tree of the same
    structure, restores each tensor leaf's dtype and device (and each numpy
    leaf's dtype)."""
    tree = torch.load(os.path.join(os.path.abspath(path), _FILE),
                      weights_only=True, map_location="cpu")
    return tree if template is None else _like(tree, template)


def nuts_checkpointed(logdensity, init, key, checkpoint_dir: str,
                      num_samples: int = 1000, block_size: int = 100,
                      num_warmup: int = 500, max_depth: int = 6,
                      initial_step: float = 0.1, target_accept: float = 0.8):
    """NUTS with per-block checkpointing and automatic resume.

    Runs warmup once (with the first block, through :func:`nuts`), then
    samples in blocks of ``block_size``; after each block the sampler's
    state (position, generator state under ``"key"``, adapted step size and
    mass, samples so far, blocks done) is written to ``checkpoint_dir``. If
    the directory already holds a state (the process was preempted),
    sampling resumes from the last completed block without warmup, drawing
    on from the stored generator state. ``key``: a ``torch.Generator`` on
    ``init``'s device, or an int seed for one.

    Returns (samples, info) like :func:`pybnesian_tpu_torch.inference.nuts`
    (info: ``step_size``, ``inv_mass``).
    """
    from ..inference.hmc import (_generator, _graphed, _nuts_step,
                                 _value_and_grad, nuts)

    state_path = os.path.join(os.path.abspath(checkpoint_dir), "state")
    num_blocks = -(-num_samples // block_size)
    device = init.device

    if os.path.isfile(os.path.join(state_path, _FILE)):
        state = load_pytree(state_path)
        state = {k: v.to(device) if k != "key" and torch.is_tensor(v) else v
                 for k, v in state.items()}
        gen = torch.Generator(device=device)
        gen.set_state(state["key"])
    else:
        gen = _generator(key, device)
        warm_samples, info = nuts(
            logdensity, init, gen, num_samples=block_size,
            num_warmup=num_warmup, max_depth=max_depth,
            initial_step=initial_step, target_accept=target_accept,
        )
        state = {
            "theta": warm_samples[-1],
            "key": gen.get_state(),
            "step": info["step_size"],
            "inv_mass": info["inv_mass"],
            "blocks_done": 1,
            "samples": warm_samples,
        }
        save_pytree(state_path, state)

    blocks_done = int(state["blocks_done"])
    if blocks_done < num_blocks:
        vg = _graphed(_value_and_grad(logdensity), init)
    while blocks_done < num_blocks:
        theta = state["theta"]
        logp, grad = vg(theta)
        drawn = []
        for _ in range(block_size):
            theta, logp, grad, _, _ = _nuts_step(
                vg, theta, logp, grad, gen, state["step"], state["inv_mass"],
                max_depth)
            drawn.append(theta)
        blocks_done += 1
        state = dict(state, theta=theta, key=gen.get_state(),
                     blocks_done=blocks_done,
                     samples=torch.cat([state["samples"],
                                        torch.stack(drawn)]))
        save_pytree(state_path, state)

    info = {"step_size": state["step"], "inv_mass": state["inv_mass"]}
    return state["samples"][:num_samples], info
