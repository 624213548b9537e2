"""Port parity: the room renderer of mam3slam_tpu_torch.io.render against
the reference's numpy renderer (same seeded textures, same trajectories,
the same ray-plane depth)."""

import numpy as np
import pytest
import torch

from mam3slam_tpu.io import render as ref
from mam3slam_tpu_torch.io import render as port

CAM = dict(width=188, height=120, fx=114.66, fy=114.32, cx=91.8, cy=62.1)


@pytest.mark.parametrize("bob", [0.05, -0.05])
def test_orbit_trajectory_matches_reference(bob):
    for (Rr, tr, Cr, _), (Rp, tp, Cp) in zip(
            ref.orbit_trajectory(7, 10, 70, radius=2.5, bob=bob),
            port.orbit_trajectory(7, 10, 70, radius=2.5, bob=bob)):
        np.testing.assert_array_equal(Rp, Rr)
        np.testing.assert_array_equal(tp, tr)
        np.testing.assert_array_equal(Cp, Cr)


def test_render_and_depth_match_reference():
    scene_r = ref.RoomScene(seed=5)
    scene_p = port.RoomScene(seed=5, device="cpu")
    for tex_r, tex_p in zip((p[2] for p in scene_r.planes),
                            scene_p.textures):
        np.testing.assert_array_equal(tex_p.numpy(), tex_r)
    for R, t, C, _ in ref.orbit_trajectory(3, 0, 120, radius=2.5, bob=0.05):
        img_r = scene_r.render(R, t, ref.RenderCam(**CAM))
        img_p = scene_p.render(R, t, port.RenderCam(**CAM)).numpy()
        # f32 vs mixed-precision ray arithmetic: sub-1e-3 grey levels
        np.testing.assert_allclose(img_p, img_r, atol=1e-3)
        # a pixel's ray hits the world point whose projection it is
        uv = np.array([[10.0, 20.0], [94.0, 60.0], [180.0, 110.0]])
        rays = np.stack([(uv[:, 0] - CAM["cx"]) / CAM["fx"],
                         (uv[:, 1] - CAM["cy"]) / CAM["fy"],
                         np.ones(3)], 1).astype(np.float32)
        _, pts = scene_p.intersect(R, t, torch.tensor(rays))
        pc = pts.numpy() @ R.T + t
        proj = pc[:, :2] / pc[:, 2:] * [CAM["fx"], CAM["fy"]] + [CAM["cx"],
                                                                 CAM["cy"]]
        np.testing.assert_allclose(proj, uv, atol=1e-3)
        assert (np.abs(pts.numpy()) <= [5.0 + 1e-4, 2.5 + 1e-4,
                                        5.0 + 1e-4]).all()
