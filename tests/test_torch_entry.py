"""The port's ``entry()`` forward against ``__graft_entry__.entry()``'s on the
same 64³ synthetic scene: the same carved grid and the same three IoU
scalars (mean part IoU of the splat, best camera of the stage-2 population,
best deform of the stage-3 batch)."""

import jax
import numpy as np

import __graft_entry__ as graft
from pbr3d_torch.entry import entry


def test_entry_forward_matches_jax():
    fn, args = graft.entry()
    ref = jax.jit(fn)(*args)
    ours_fn, ours_args = entry(device="cpu")
    ours = ours_fn(*ours_args)
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref[0]))
    assert (ours[0].numpy() > 0).sum() > 1000
    scalars = [float(v) for v in ours[1:]]
    assert scalars == [float(v) for v in ref[1:]]
    # the planted optimum (shift_y = 3 onto the dome rolled 3 rows) scores well
    assert scalars[2] > 0.4 and 0 < scalars[0] < 1 and 0 < scalars[1] < 1
