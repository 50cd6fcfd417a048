"""Checkpoint / resume of fitted parameters and progressive state.

The reference has no checkpointing — its only state is the camera pose
and a G-buffer rebuilt in milliseconds (SURVEY §5). This build adds
real persistent state worth saving: fitted ``SceneParams``, the optax
optimizer state of a fitting run, and the frameless accumulation state
(``ProgressiveState`` — G-buffer planes plus the Sobol sample cursor
and scramble seed, whose restoration makes a resumed run bit-identical
to an uninterrupted one).

Format: a single ``.npz``. Each named component pytree is flattened in
`jax.tree_util` order and its leaves stored as ``<name>/<i>`` arrays;
loading unflattens into the caller-provided *template* pytree (same
structure, e.g. a freshly-initialized state), which keeps the format
free of any pickled code.
"""

from __future__ import annotations

from typing import Any, Mapping

import jax
import numpy as np

Pytree = Any


def save_checkpoint(path: str, **components: Pytree) -> None:
    """Save named pytrees (e.g. scene=..., opt_state=..., progressive=...)."""
    out = {}
    for name, tree in components.items():
        if "/" in name:
            raise ValueError(f"component name may not contain '/': {name}")
        leaves = jax.tree_util.tree_leaves(tree)
        for i, leaf in enumerate(leaves):
            out[f"{name}/{i}"] = np.asarray(leaf)
    np.savez(path, **out)


def load_checkpoint(
    path: str, templates: Mapping[str, Pytree]
) -> dict[str, Pytree]:
    """Load components back into the structure of `templates`.

    Each template must have the same pytree structure (and leaf count)
    as the saved component; leaf dtypes/shapes come from the file.
    """
    with np.load(path) as data:
        out = {}
        for name, template in templates.items():
            leaves, treedef = jax.tree_util.tree_flatten(template)
            keys = [f"{name}/{i}" for i in range(len(leaves))]
            missing = [k for k in keys if k not in data]
            if missing:
                raise KeyError(
                    f"checkpoint {path} lacks leaves for component "
                    f"'{name}': {missing[:3]}{'...' if len(missing) > 3 else ''}"
                )
            n_stored = sum(
                1 for k in data.files if k.startswith(f"{name}/")
            )
            if n_stored != len(leaves):
                raise ValueError(
                    f"component '{name}': template has {len(leaves)} "
                    f"leaves but checkpoint stores {n_stored}"
                )
            loaded = [
                jax.numpy.asarray(data[k]) for k in keys
            ]
            out[name] = jax.tree_util.tree_unflatten(treedef, loaded)
    return out
