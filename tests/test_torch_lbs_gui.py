"""The port's SMPL-X skinning (``lbs.py``) and viewer protocol
(``network_gui.py``) against the JAX package's, on the CPU.

LBS runs on ``tests/test_lbs.py``'s toy chain and at SMPL-X's shapes filled
with seeded arrays (10,475 vertices, 55 joints, 10 shape and 10 expression
directions, a (486, 31,425) ``posedirs``); no SMPL-X model ships with the
repo. Tolerances: the toy chain atol 1e-5; at SMPL-X's shapes vertices atol
2e-5 (float32, the 486-long pose-corrective dot and a 55-joint chain of 4×4
products summed in different orders; vertices are O(1)) and joint
transforms atol 1e-5; ``prepare_lbs`` atol 5e-5 (it inverts the transforms
in float64 from the float32 ones).
"""
import json
import socket
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_garments_tpu import lbs as JL
from gaussian_garments_tpu import network_gui as JGUI
from gaussian_garments_tpu_torch import lbs as TL
from gaussian_garments_tpu_torch import network_gui as TGUI
from test_lbs import _toy_model

N_V, N_J, N_F = 10475, 55, 20908


def _smplx_shaped(rng):
    """SMPL-X's array shapes with seeded contents of plausible scale."""
    v = (rng.randn(N_V, 3) * 0.3).astype(np.float32)
    jr = np.zeros((N_J, N_V), np.float32)
    for j in range(N_J):
        idx = rng.choice(N_V, 20, replace=False)
        jr[j, idx] = rng.dirichlet(np.ones(20))
    w = np.zeros((N_V, N_J), np.float32)
    near = rng.randint(0, N_J, size=(N_V, 4))
    w[np.arange(N_V)[:, None], near] = rng.dirichlet(np.ones(4), size=N_V)
    parents = np.concatenate([[-1], [rng.randint(0, i) for i in range(1, N_J)]]).astype(np.int64)
    return JL.SmplxModel(
        v_template=v,
        shapedirs=(rng.randn(N_V, 3, 10) * 0.01).astype(np.float32),
        expr_dirs=(rng.randn(N_V, 3, 10) * 0.01).astype(np.float32),
        posedirs=(rng.randn((N_J - 1) * 9, N_V * 3) * 0.01).astype(np.float32),
        J_regressor=jr, parents=parents, lbs_weights=w,
        left_hand_components=rng.randn(12, 45).astype(np.float32) * 0.1,
        right_hand_components=rng.randn(12, 45).astype(np.float32) * 0.1,
        pose_mean=(rng.randn(165) * 0.1).astype(np.float32),
        faces=rng.randint(0, N_V, size=(N_F, 3)).astype(np.int64))


def _params(rng):
    r = lambda *s: (rng.randn(*s) * 0.3).astype(np.float32)
    return {"betas": r(10), "expression": r(10), "global_orient": r(3), "body_pose": r(63),
            "jaw_pose": r(3), "leye_pose": r(3), "reye_pose": r(3), "left_hand_pose": r(12),
            "right_hand_pose": r(12), "transl": r(3)}


def _both_lbs(m, betas, pose):
    dirs = np.concatenate([m.shapedirs, m.expr_dirs], axis=-1)
    j = JL.lbs(jnp.asarray(betas), jnp.asarray(pose), jnp.asarray(m.v_template), jnp.asarray(dirs),
               jnp.asarray(m.posedirs), jnp.asarray(m.J_regressor), m.parents,
               jnp.asarray(m.lbs_weights))
    t = TL.lbs(torch.from_numpy(betas), torch.from_numpy(pose), torch.from_numpy(m.v_template),
               torch.from_numpy(dirs), torch.from_numpy(m.posedirs),
               torch.from_numpy(m.J_regressor), m.parents, torch.from_numpy(m.lbs_weights))
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def test_toy_chain_matches_jax(rng):
    m = _toy_model(rng)
    pose = (rng.randn(1, m.J_regressor.shape[0] * 3) * 0.5).astype(np.float32)
    betas = np.zeros((1, 20), np.float32)
    want, got = _both_lbs(m, betas, pose)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5)
    r = rng.randn(6, 3).astype(np.float32)
    np.testing.assert_allclose(TL.batch_rodrigues(torch.from_numpy(r)).numpy(),
                               np.asarray(JL.batch_rodrigues(jnp.asarray(r))), atol=1e-6)


def test_smplx_shapes_match_jax():
    rng = np.random.RandomState(0)
    m = _smplx_shaped(rng)
    betas = (rng.randn(1, 20) * 0.5).astype(np.float32)
    pose = (rng.randn(1, N_J * 3) * 0.3).astype(np.float32)
    (jA, jv, joff), (tA, tv, toff) = _both_lbs(m, betas, pose)
    assert tv.shape == (N_V, 3) and tA.shape == (N_J, 4, 4)
    np.testing.assert_allclose(tA, jA, atol=1e-5)
    np.testing.assert_allclose(toff, joff, atol=1e-5)
    np.testing.assert_allclose(tv, jv, atol=2e-5)

    p = _params(rng)
    want = JL.smplx_pose2mesh(m, p)
    got = TL.smplx_pose2mesh(TL.SmplxModel(*m), p, device="cpu")
    np.testing.assert_allclose(got["vertices"], want["vertices"], atol=2e-5)
    np.testing.assert_array_equal(got["faces"], want["faces"])


def test_prepare_lbs_matches_jax():
    rng = np.random.RandomState(1)
    m = _smplx_shaped(rng)
    p = _params(rng)
    garment = (rng.randn(500, 3) * 0.3).astype(np.float32)
    jv, jw, jnn = JL.prepare_lbs(m, p, garment, unpose=True)
    tv, tw, tnn = TL.prepare_lbs(TL.SmplxModel(*m), p, garment, unpose=True, device="cpu")
    np.testing.assert_array_equal(tnn, jnn)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_allclose(tv, jv, atol=5e-5)
    # and back: re-pose the canonical vertices with the same weights
    jr, _, _ = JL.prepare_lbs(m, p, jv, blend_weights=jw, nn_ids=jnn)
    tr, _, _ = TL.prepare_lbs(TL.SmplxModel(*m), p, tv, blend_weights=tw, nn_ids=tnn,
                              device="cpu")
    np.testing.assert_allclose(tr, jr, atol=5e-5)


def test_network_gui_roundtrip():
    """``test_aux.py::TestNetworkGUI``'s round trip with the port's class;
    the received camera equals the JAX package's parse of the message."""
    gui = TGUI.NetworkGUI()
    gui.init("127.0.0.1", 0)
    port = gui.listener.getsockname()[1]
    view = np.eye(4)
    view[3, :3] = [0.1, -0.2, 2.0]
    msg = {
        "resolution_x": 32, "resolution_y": 16, "train": True,
        "fov_y": 0.8, "fov_x": 1.0, "z_near": 0.01, "z_far": 100.0,
        "shs_python": False, "rot_scale_python": False, "keep_alive": True,
        "scaling_modifier": 1.0,
        "view_matrix": list(view.ravel().astype(float)),
        "view_projection_matrix": list(np.eye(4).ravel().astype(float)),
    }
    received = {}

    def client():
        s = socket.create_connection(("127.0.0.1", port))
        payload = json.dumps(msg).encode()
        s.sendall(len(payload).to_bytes(4, "little") + payload)
        buf = b""
        while len(buf) < 32 * 16 * 3:
            buf += s.recv(32 * 16 * 3 - len(buf))
        received["img"] = buf
        n = int.from_bytes(s.recv(4), "little")
        received["verify"] = s.recv(n).decode()
        s.close()

    th = threading.Thread(target=client)
    th.start()
    for _ in range(500):
        gui.try_connect()
        if gui.conn is not None:
            break
        time.sleep(0.01)
    assert gui.conn is not None
    cam, do_training, shs, rot, keep, scale = gui.receive()
    assert cam.image_width == 32 and cam.image_height == 16 and do_training and keep
    gui.send(bytes(range(256)) * (32 * 16 * 3 // 256), "ok")
    th.join(10)
    gui.conn.close()
    gui.listener.close()
    assert received["verify"] == "ok"
    assert received["img"] == bytes(range(256)) * (32 * 16 * 3 // 256)

    wv = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
    wv[:, 1:3] *= -1
    fp = np.array(msg["view_projection_matrix"], np.float32).reshape(4, 4)
    fp[:, 1] *= -1
    jcam = JGUI.MiniCam(32, 16, 0.8, 1.0, 0.01, 100.0, wv, fp)
    for k in ("world_view_transform", "full_proj_transform", "camera_center"):
        np.testing.assert_array_equal(getattr(cam, k), getattr(jcam, k))
    assert (cam.tanfovx, cam.tanfovy) == (jcam.tanfovx, jcam.tanfovy)
