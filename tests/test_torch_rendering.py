"""The port's sphere renderer, compositors and dataset builder against the
JAX package, on the CPU.

Unit level: seeded cameras (tilted, offset, different focal lengths) and
sphere sets (random rotations, overlaps, one frame of zero radii) go
through JAX's ``render_spheres`` frame by frame and the port's batched one.
Hit masks are held by a count (at most 0.1% of pixels may differ, where a
ray grazes a sphere and the two einsum orders round ``disc`` apart) and the
images on the pixels both hit or both miss to 1e-5; the runs here found
0 differing pixels. End to end: both packages' ``render_data`` CLIs on one
exported fake tree (2 episodes of 8 frames at 32 px, 4 cameras, both draw
sets, with and without texture files): every PNG within 1 level of JAX's
except on at most 0.1% of pixels (0 of 245,760 found in each run), the same
file names, and the config snapshots byte-equal.
"""

import pickle
import shutil

import jax
import numpy as np
import pytest
import torch
from PIL import Image
from scipy.spatial.transform import Rotation

from genima_tpu.cli import render_data as jax_cli
from genima_tpu.envs.export import export_demos_rlbench_format as jax_export
from genima_tpu.envs.fake import FakeRLBenchFactory as JaxFakeFactory
from genima_tpu.rendering import compositor as jax_comp
from genima_tpu.rendering import spheres as jax_spheres

from genima_torch.cli import render_data as port_cli
from genima_torch.core.config import RENDER
from genima_torch.rendering import compositor, spheres
from genima_torch.rendering.render_data import RenderData, to_uint8

IMAGE_ATOL = 1e-5
MAX_MASK_SHARE = 1e-3  # hit-mask (or stripe-edge) pixels that may differ
TASK = "fake_reach_visual"
CAMERAS = ["wrist", "front", "right_shoulder", "left_shoulder"]


def _frames(n=6, s=4, seed=0):
    """Seeded frames: camera tilts and offsets, focal lengths, sphere sets
    that overlap in depth; the last frame has zero radii."""
    rng = np.random.RandomState(seed)
    intr = np.stack([np.array([[rng.uniform(40, 90), 0, 32 + rng.uniform(-3, 3)],
                               [0, rng.uniform(40, 90), 32], [0, 0, 1]], np.float32)
                     for _ in range(n)])
    pose = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        pose[i, :3, :3] = Rotation.from_euler("xyz", rng.uniform(-0.2, 0.2, 3)).as_matrix()
        pose[i, :3, 3] = rng.uniform(-0.1, 0.1, 3)
    centers = rng.uniform([-0.3, -0.3, 0.8], [0.3, 0.3, 1.6], (n, s, 3)).astype(np.float32)
    rots = Rotation.random(n * s, random_state=seed + 1).as_matrix().reshape(n, s, 3, 3)
    radii = rng.uniform(0.05, 0.25, (n, s)).astype(np.float32)
    radii[-1] = 0.0
    stripes = rng.uniform(0, 1, (n, s, 3)).astype(np.float32)
    factors = rng.uniform(0.5, 1, (n, s, 3)).astype(np.float32)
    return intr, pose, centers, rots.astype(np.float32), radii, stripes, factors


_jax_render_one = jax.jit(jax_spheres.render_spheres, static_argnums=(7, 8))


def _jax_render(args, h, w):
    outs = [_jax_render_one(*a, h, w) for a in zip(*args)]
    return (np.stack([np.asarray(o[0]) for o in outs]),
            np.stack([np.asarray(o[1]) for o in outs]))


def _assert_render_close(got, want):
    (img, mask), (jimg, jmask) = got, want
    img, mask = img.numpy(), mask.numpy()
    flips = int((mask != jmask).sum())
    assert flips <= MAX_MASK_SHARE * mask.size, flips
    same = mask == jmask
    np.testing.assert_allclose(img[same], jimg[same], atol=IMAGE_ATOL)
    return flips


def test_render_spheres_matches_jax():
    args = _frames()
    got = spheres.render_spheres(*map(torch.from_numpy, args), 64, 64)
    want = _jax_render(args, 64, 64)
    _assert_render_close(got, want)
    assert got[0].shape == (6, 64, 64, 3) and got[1].dtype == torch.bool
    assert want[1][:-1].any(axis=(1, 2)).all()  # every frame with radii draws spheres
    assert not got[1][-1].any()  # zero radii draw nothing
    assert torch.all(got[0][~got[1]] == 1.0)  # white background


def test_render_spheres_stripes_and_occlusion_match_jax():
    """A sphere behind a larger nearer one, and a sphere large enough to
    show several stripes: the nearer one wins, both colours and black occur."""
    intr = np.array([[[100, 0, 32], [0, 100, 32], [0, 0, 1]]], np.float32)
    pose = np.eye(4, dtype=np.float32)[None]
    centers = np.array([[[0, 0, 1.0], [0, 0, 2.0], [0.2, 0.1, 0.7]]], np.float32)
    rots = np.stack([np.eye(3), Rotation.from_euler("z", 0.4).as_matrix(),
                     np.eye(3)]).astype(np.float32)[None]
    radii = np.array([[0.1, 0.3, 0.15]], np.float32)
    stripes = np.stack([spheres.STRIPE_COLORS[c] for c in ("red", "green", "cyan")])[None]
    factors = np.stack([spheres.SPHERE_BASE_FACTORS[f] for f in ("open", "open", "closed")])[None]
    args = (intr, pose, centers, rots, radii, stripes, factors)
    got = spheres.render_spheres(*map(torch.from_numpy, args), 64, 64)
    _assert_render_close(got, _jax_render(args, 64, 64))
    img, mask = got[0][0].numpy(), got[1][0].numpy()
    on = img[mask]
    assert (on.max(-1) > 0.3).any() and (on.max(-1) < 0.1).any()  # colour and black bands
    assert img[32, 32, 1] < 0.1 or img[32, 32, 0] > img[32, 32, 1]  # red (or black), not green


def test_compositors_match_jax():
    rng = np.random.RandomState(2)
    render, rgb, tex = (rng.uniform(0, 1, (3, 8, 8, 3)).astype(np.float32) for _ in range(3))
    mask = rng.rand(3, 8, 8) > 0.5
    blend = rng.uniform(0.7, 1.0, 3).astype(np.float32)
    got = compositor.composite_rgb_rendered(*map(torch.from_numpy, (render, mask, rgb)))
    for i in range(3):
        want = jax_comp.composite_rgb_rendered(render[i], mask[i], rgb[i])
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    got = compositor.composite_rnd_bg(*map(torch.from_numpy, (render, mask, tex)),
                                      torch.from_numpy(blend)[:, None, None, None])
    for i in range(3):
        want = jax_comp.composite_rnd_bg(render[i], mask[i], tex[i], blend[i])
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), atol=1e-7)


def test_to_uint8_rounds_half_to_even_as_jnp_round():
    x = torch.tensor([0.5, 1.5, 2.5, 254.5, 3.2, -4.0, 300.0]) / 255.0
    want = jax.numpy.round(jax.numpy.clip(x.numpy(), 0, 1) * 255).astype(jax.numpy.uint8)
    np.testing.assert_array_equal(to_uint8(x).numpy(), np.asarray(want))


def test_sphere_params_match_jax():
    jp = {j: np.concatenate([np.random.RandomState(j).uniform(-1, 1, 3),
                             Rotation.random(random_state=j).as_quat()]) for j in (1, 3, 5)}
    gm = np.eye(4)
    gm[:3, 3] = [0.1, 0.2, 0.3]
    for open_ in (1.0, 0.0):
        got = spheres.sphere_params_for_timestep(gm, open_, jp, [1, 3, 5], 0.01, 6.5)
        want = jax_spheres.sphere_params_for_timestep(gm, open_, jp, [1, 3, 5], 0.01, 6.5)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert spheres.JOINT_COLOR_MAP == jax_spheres.JOINT_COLOR_MAP


def test_render_config_is_the_jax_yaml():
    import yaml

    with open(jax_cli.DEFAULT_CFG) as f:
        assert RENDER == yaml.safe_load(f)


# -- the dataset builder end to end ------------------------------------------------------


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    """2 goal-observable fake episodes of 8 frames at 32 px, exported by JAX,
    and two texture files (of another size: they are resized)."""
    root = tmp_path_factory.mktemp("render")
    demos = JaxFakeFactory(task_name=TASK, image_size=32, demo_length=8, episode_length=16,
                           goal_observable=True, seed=0).collect_or_fetch_demos(2)
    jax_export(demos, root / "raw", TASK)
    tex = root / "textures"
    tex.mkdir()
    rng = np.random.RandomState(4)
    for i in range(2):
        Image.fromarray(rng.randint(0, 256, (20, 40, 3), np.uint8)).save(tex / f"t{i}.png")
    return root


def _argv(root, out, textures):
    return [f"dataset_root={root / 'raw'}", f"save_path={out}", f"task={TASK}", "episodes=2",
            "image_width=32", "image_height=32", "action_horizon=3", "seed=5",
            f"cameras=[{','.join(CAMERAS)}]", "camera_scales=[1.0,1.0,1.0,1.0]",
            "render.sphere.radius=0.11",
            f"textures_path={root / 'textures' if textures else 'null'}"]


def _tree_files(root):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


@pytest.mark.parametrize("textures", [True, False])
def test_render_data_cli_matches_jax(raw_tree, tmp_path, textures):
    """Both CLIs write into the same save_path in turn (JAX's trees moved
    aside), so the snapshots' paths are the same."""
    out = tmp_path / "out"
    jax_cli.main(_argv(raw_tree, out, textures))
    for kind in ("rgb_rendered", "rnd_bg"):
        shutil.move(out / f"raw_{kind}", tmp_path / f"jax_{kind}")
    port_cli.main(_argv(raw_tree, out, textures) + ["device=cpu"])
    differing = total = 0
    for kind in ("rgb_rendered", "rnd_bg"):
        got_root, want_root = out / f"raw_{kind}", tmp_path / f"jax_{kind}"
        files = _tree_files(want_root)
        assert _tree_files(got_root) == files
        assert ((got_root / "render_data_config.yaml").read_bytes()
                == (want_root / "render_data_config.yaml").read_bytes())
        for rel in files:
            if rel.suffix == ".png":
                got = np.asarray(Image.open(got_root / rel), np.int16)
                want = np.asarray(Image.open(want_root / rel), np.int16)
                assert got.shape == want.shape, rel
                diff = np.abs(got - want).max(-1)
                differing += int((diff > 1).sum())
                total += diff.size
            else:  # the copied source tree
                assert (got_root / rel).read_bytes() == (want_root / rel).read_bytes(), rel
    assert total > 0 and differing <= MAX_MASK_SHARE * total, (differing, total)
    ep0 = out / "raw_rgb_rendered" / TASK / "variation0" / "episodes" / "episode0"
    raw0 = raw_tree / "raw" / TASK / "variation0" / "episodes" / "episode0"
    # frames 0-6 drawn on; the last has no target and stays the copied source
    assert len(list((ep0 / "wrist_rgb").glob("*.png"))) == 8
    assert (ep0 / "wrist_rgb" / "7.png").read_bytes() == (raw0 / "wrist_rgb" / "7.png").read_bytes()
    assert len(list((ep0 / "tiled_rgb_rendered").glob("*.png"))) == 7
    assert Image.open(ep0 / "tiled_rgb_rendered" / "0.png").size == (64, 64)
    raw = np.asarray(Image.open(raw0 / "front_rgb" / "0.png"))
    assert (np.asarray(Image.open(ep0 / "front_rgb" / "0.png")) != raw).any()  # spheres drawn


def test_render_data_draws_background_like_jax(raw_tree):
    """Both packages' RandomState draws per frame: a texture file (resized)
    or a uniform colour, then the blend."""
    cfg = {**RENDER, "dataset_root": str(raw_tree / "raw"), "task": TASK,
           "textures_path": str(raw_tree / "textures"), "image_width": 32, "image_height": 32,
           "draw": {"rgb_rendered": False, "rnd_bg": False}}
    rd = RenderData(cfg, device="cpu")
    rng_a, rng_b = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(3):
        with Image.open(rng_b.choice(rd._texture_files)) as img:
            want = np.asarray(img.convert("RGB").resize((32, 32)), np.float32) / 255.0
        np.testing.assert_array_equal(rd._background(rng_a), want)
    rd._texture_files = []
    np.testing.assert_array_equal(rd._background(rng_a)[0, 0],
                                  rng_b.uniform(0, 1, 3).astype(np.float32))


def test_render_data_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        RenderData({**RENDER, "draw": {"rgb_rendered": False, "rnd_bg": False}})


def test_low_dim_obs_survives_the_copy(raw_tree, tmp_path):
    """The rendered tree keeps the source episode's low_dim_obs.pkl, which
    the rendered-demo factory reads back."""
    out = tmp_path / "out"
    port_cli.main(_argv(raw_tree, out, False) + ["device=cpu", "draw.rnd_bg=false"])
    rel = f"{TASK}/variation0/episodes/episode1/low_dim_obs.pkl"
    with open(out / "raw_rgb_rendered" / rel, "rb") as f, open(raw_tree / "raw" / rel, "rb") as g:
        assert len(pickle.load(f)) == len(pickle.load(g)) == 8
    assert not (out / "raw_rnd_bg").exists()
