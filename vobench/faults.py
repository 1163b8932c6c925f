"""Faults planted under the timed path, each of which must make ``correct``
false: the tests plant them on the CPU, and ``control.py --fault`` reads
them on the card.

Each function patches the port in place and returns a function that undoes
the patch.  Plant a fault before the harness builds the port's entry:
``MultiStreamVO`` binds the step's halves when it is constructed.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree


def _patch(owner, name: str, new):
    old = getattr(owner, name)
    setattr(owner, name, new)
    return lambda: setattr(owner, name, old)


def state_unchanged():
    """The update half returns the state it was given."""
    from rgbd_visualodometry_tpu_torch.pipeline import frontend

    update = frontend.apply_updates

    def broken(cfg, camera, state, it, shard=None):
        return state, update(cfg, camera, state, it, shard)[1]

    return _patch(frontend, "apply_updates", broken)


def answer_altered():
    """Every record's T_w_c translation is 1 cm off in x."""
    from rgbd_visualodometry_tpu_torch.pipeline import frontend

    update = frontend.apply_updates

    def broken(cfg, camera, state, it, shard=None):
        state, out = update(cfg, camera, state, it, shard)
        shift = torch.zeros(out.packed.shape[-1], dtype=out.packed.dtype, device=out.packed.device)
        shift[11] = 0.01
        return state, out._replace(packed=out.packed + shift)

    return _patch(frontend, "apply_updates", broken)


def map_moved():
    """Every live map point is 1 cm off in x after the update half."""
    from rgbd_visualodometry_tpu_torch.pipeline import frontend

    update = frontend.apply_updates

    def broken(cfg, camera, state, it, shard=None):
        state, out = update(cfg, camera, state, it, shard)
        shift = torch.tensor([0.01, 0.0, 0.0], dtype=state.mp_pos.dtype, device=state.mp_pos.device)
        return state.replace(mp_pos=torch.where(state.mp_valid[..., None], state.mp_pos + shift, state.mp_pos)), out

    return _patch(frontend, "apply_updates", broken)


def half_left_out():
    """A fleet step advances the first half of the streams only."""
    from rgbd_visualodometry_tpu_torch.parallel import MultiStreamVO

    step = MultiStreamVO.step

    def broken(self, rgb, depth=None, timestamps=None):
        before = self.states
        out = step(self, rgb, depth, timestamps)
        h = self.n_streams // 2
        self.states = pytree.tree_map(lambda new, old: torch.cat([new[:h], old[h:]]), self.states, before)
        return out

    return _patch(MultiStreamVO, "step", broken)


FAULTS = {f.__name__: f for f in (state_unchanged, answer_altered, map_moved, half_left_out)}
