"""The port's visualizers on the CPU: meshcat's command stream against the
JAX package's (its uuids masked), the ZMQ transport against a stub server
(tests/test_visualizer.py's round trip), and the software renderer's image
of a laikago state against the JAX renderer's, with its PNG bytes."""

import os
import re
import threading

import pytest

torch = pytest.importorskip("torch")
msgpack = pytest.importorskip("msgpack")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tds_tpu.urdf.converter import convert_to_multibody as j_convert  # noqa: E402
from tds_tpu.urdf.parser import parse_urdf_string as j_parse  # noqa: E402
from tds_tpu.visualizer import meshcat as j_meshcat  # noqa: E402
from tds_tpu.visualizer import renderer as j_renderer  # noqa: E402
from tds_tpu_torch.urdf.converter import convert_to_multibody  # noqa: E402
from tds_tpu_torch.urdf.parser import parse_urdf_string  # noqa: E402
from tds_tpu_torch.visualizer import meshcat, renderer  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


URDF = """
<robot name="viz">
  <link name="world"/>
  <link name="ball">
    <visual><geometry><sphere radius="0.25"/></geometry>
      <material name="m"><color rgba="1 0 0 1"/></material></visual>
    <visual><origin xyz="0.1 0 0.2" rpy="0.3 -0.2 0.1"/><geometry><box size="0.2 0.1 0.3"/></geometry></visual>
    <inertial><mass value="1"/><inertia ixx="0.1" iyy="0.1" izz="0.1"/></inertial>
  </link>
  <link name="arm">
    <visual><origin xyz="0 0 0.3"/><geometry><cylinder radius="0.05" length="0.6"/></geometry></visual>
    <inertial><mass value="0.5"/><inertia ixx="0.01" iyy="0.01" izz="0.01"/></inertial>
  </link>
  <joint name="j" type="continuous"><parent link="world"/><child link="ball"/>
    <origin xyz="0 0 1"/><axis xyz="1 0 0"/></joint>
  <joint name="k" type="revolute"><parent link="ball"/><child link="arm"/>
    <origin xyz="0 0.1 0" rpy="0 0.4 0"/><axis xyz="0 1 0"/></joint>
</robot>
"""
UUID = re.compile(r"^[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}$")


def masked(value):
    """A decoded command with every uuid string replaced by a mark."""
    if isinstance(value, dict):
        return {k: masked(v) for k, v in value.items()}
    if isinstance(value, list):
        return [masked(v) for v in value]
    if isinstance(value, str) and UUID.match(value):
        return "<uuid>"
    return value


def assert_same_stream(got, want):
    assert [c[:2] for c in got] == [c[:2] for c in want]
    for (_, path, g), (_, _, w) in zip(got, want):
        g, w = masked(msgpack.unpackb(g)), masked(msgpack.unpackb(w))
        if "matrix" in w:
            np.testing.assert_allclose(g.pop("matrix"), w.pop("matrix"), rtol=0.0, atol=1e-12, err_msg=path)
        assert g == w, path


def test_meshcat_stream_matches_jax():
    """The visuals of a small URDF and two states' transforms: the same
    commands, paths and payloads as the JAX visualizer's, uuids masked,
    matrices within 1e-12; the primitives' calls too."""
    streams = []
    for parse, convert, module, q in (
        (j_parse, j_convert, j_meshcat, lambda v: jnp.asarray(v)),
        (parse_urdf_string, convert_to_multibody, meshcat, lambda v: torch.tensor(v, dtype=torch.float64)),
    ):
        urdf = parse(URDF)
        model, _ = convert(urdf, False)
        conn = module.RecordingConnection()
        viz = module.MeshcatUrdfVisualizer(module.MeshcatVisualizer(connection=conn))
        viz.convert_visuals(urdf, model)
        for state in ([0.0, 0.0], [0.7, -1.1]):
            viz.sync_visual_transforms(model, q(state))
        raw = viz.viz
        raw.set_capsule("/tds/capsule", 0.1, 0.4, opacity=0.5)
        raw.set_ground_plane()
        raw.set_mesh_obj("/tds/mesh", "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
        raw.set_transform("/tds/mesh", [1.0, 2.0, 3.0], np.eye(3))
        raw.delete("/tds/mesh")
        streams.append(conn.commands)
    assert len(streams[0]) == 3 + 2 * 3 + 5
    assert_same_stream(streams[1], streams[0])
    tf = msgpack.unpackb(streams[1][3][2])
    np.testing.assert_allclose(tf["matrix"][12:15], [0.0, 0.0, 1.0], atol=1e-12)


def test_zmq_round_trip_against_stub_server():
    """ZmqConnection's REQ socket against a stub REP server: three 3-part
    messages cross, and each REQ/REP handshake completes."""
    zmq = pytest.importorskip("zmq")
    ctx = zmq.Context.instance()
    rep = ctx.socket(zmq.REP)
    port = rep.bind_to_random_port("tcp://127.0.0.1")
    received = []

    def serve(n):
        for _ in range(n):
            received.append(rep.recv_multipart())
            rep.send(b"ok")

    t = threading.Thread(target=serve, args=(3,), daemon=True)
    t.start()
    viz = meshcat.MeshcatVisualizer(connection=meshcat.ZmqConnection(f"tcp://127.0.0.1:{port}", timeout_ms=5000))
    viz.set_sphere("/tds/ball", 0.25, color=0x112233)
    viz.set_transform("/tds/ball", [1.0, 2.0, 3.0])
    viz.delete("/tds/ball")
    t.join(timeout=10)
    assert not t.is_alive()
    rep.close(linger=0)
    assert [len(p) for p in received] == [3, 3, 3]
    assert [p[0].decode() for p in received] == ["set_object", "set_transform", "delete"]
    obj = msgpack.unpackb(received[0][2])
    assert obj["path"] == "/tds/ball" and obj["object"]["geometries"][0]["radius"] == 0.25
    assert msgpack.unpackb(received[1][2])["matrix"][12:15] == [1.0, 2.0, 3.0]


LAIKAGO = "laikago/laikago_toes_zup_xyz_xyzrot.urdf"


def laikago_state():
    """A laikago pose: base at 0.45 m, tilted, joints off their initial poses."""
    rng = np.random.default_rng(0)
    q = np.zeros(18)
    q[2] = 0.45
    q[3:6] = rng.uniform(-0.1, 0.1, 3)
    q[6:] = np.array([0.2, 0.0, -0.7] * 4) + rng.uniform(-0.2, 0.2, 12)
    return q


def test_renderer_matches_jax(tmp_path):
    """The laikago's visuals (its OBJ meshes) and a plane, posed by each
    package's kinematics and rasterised: at most 0.1% of the pixels differ
    from the JAX renderer's, and save_png writes the same bytes for the
    same image."""
    from tds_tpu.urdf.cache import construct as j_construct
    from tds_tpu.urdf.cache import load_document as j_load
    from tds_tpu_torch.urdf.cache import construct, load_document
    from tds_tpu_torch.utils.file_utils import find_file

    urdf_dir = os.path.dirname(find_file(LAIKAGO))
    q = laikago_state()
    images = []
    for module, load, build, state in (
        (j_renderer, j_load, j_construct, jnp.asarray(q)),
        (renderer, load_document, construct, torch.tensor(q, dtype=torch.float64)),
    ):
        instances = module.scene_instances_from_urdf(load(LAIKAGO), build(LAIKAGO)[0], state, urdf_dir)
        pv, pf = module.plane_mesh()
        instances.append(module.Instance(pv, pf, np.zeros(3), np.eye(3), (0.5, 0.5, 0.55)))
        cam = module.Camera.look_at(eye=(0.9, -0.8, 0.7), target=(0.0, 0.0, 0.3), width=240, height=180)
        images.append(module.render_scene(cam, instances))
    want, got = images
    robot = (want != want[0, 0]).any(-1).mean()
    differ = (got != want).any(-1).mean()
    assert robot > 0.05, robot  # the robot fills a fair share of the frame
    assert differ <= 1e-3, differ
    paths = [str(tmp_path / "jax.png"), str(tmp_path / "port.png")]
    j_renderer.save_png(want, paths[0])
    renderer.save_png(want, paths[1])
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


def test_world_instances_and_gym_render_message():
    """scene_instances_from_world poses a world's shapes, and the gym
    wrapper's render points to the renderer."""
    from tds_tpu_torch.envs.gym_wrapper import GymEnv
    from tds_tpu_torch.envs.cartpole import CartpoleEnv
    from tds_tpu_torch.world import build_world, make_ground_plane
    from tds_tpu_torch.model.geometry import GeomAttachment, Sphere
    from tds_tpu_torch.model.multibody import MultiBodyBuilder

    b = MultiBodyBuilder(is_floating=True, name="ball")
    b.set_base_inertia(1.0, (0, 0, 0), np.eye(3) * 0.1)
    ball = b.finalize(dtype=torch.float64, device="cpu")
    world = build_world([make_ground_plane(device="cpu"), (ball, (GeomAttachment(-1, Sphere(0.2), pos=(0.0, 0.0, 0.1)),))])
    q = ball.zero_q()
    q[4:7] = torch.tensor([1.0, 2.0, 3.0])
    inst = renderer.scene_instances_from_world(world, (torch.zeros(0, dtype=torch.float64), q))
    assert len(inst) == 2
    np.testing.assert_allclose(inst[1].position, [1.0, 2.0, 3.1], atol=1e-12)
    with pytest.raises(NotImplementedError, match="visualizer.renderer"):
        GymEnv(CartpoleEnv(dtype=torch.float64, device="cpu")).render()
