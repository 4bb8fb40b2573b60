"""tcnerf_torch's task layer and data collection against the JAX package on
the CPU: the plugin factory and loader, the four task factories, the
suction and insertion oracles, the primitives on the virtual scene's
logging robot, `transform_utils`, `VirtualScene.get_observation`,
`collect_grasp_dataset` and its CLI, validation with the suction oracle
and `build_oracle`.

Both sides are numpy + scipy, so every comparison is bit for bit: poses,
errors and images with `assert_array_equal` or `==`, pickles byte for
byte. `PickObject.get_valid_poses` draws from an unseeded generator in
both packages; the tests that reach it seed `np.random.default_rng()`.
"""

import json

import numpy as np
import pytest

from test_session_loop import FakeOptimizer
from test_torch_grasp_data import JCONFIGS, PortFake, _tree
from tcnerf.data import collect as jcollect
from tcnerf.tasks import agents as jagents
from tcnerf.tasks import factory as jfactory
from tcnerf.tasks import loader as jloader
from tcnerf.tasks.plugins.objects import base as jbase
from tcnerf.tasks.transform import Affine as JAffine
from tcnerf.tasks.transform_utils import differences as jdiff
from tcnerf.tasks.transform_utils import random as jrandom
from tcnerf.train import config as jconfig
from tcnerf.train import session as jsession
from tcnerf_torch.data import collect
from tcnerf_torch.tasks import agents, factory, loader
from tcnerf_torch.tasks.plugins.objects import base
from tcnerf_torch.tasks.plugins.oracles.suction_grasp import (
    SuctionGraspOracle)
from tcnerf_torch.tasks.transform import Affine
from tcnerf_torch.tasks.transform_utils import differences, random
from tcnerf_torch.train import config, grasp_common, session

PLUGINS = ["objects", "pick_and_place", "grasp_task", "simple_task",
           "box_packing_task", "kitting_task", "suction_grasp", "insertion",
           "virtual_scene"]
OFFSET = {"rotation": [np.pi, 0.0, np.pi / 2]}
# (JAX, port): each package's own factory, loader and Affine
SIDES = {"jax": (jfactory, jloader, JAffine), "port": (factory, loader, Affine)}


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """A "box" object type in both packages' factories: a pick object on a
    segment (tests/test_data_tasks.py's) and a target object with 4-fold
    symmetric valid poses."""
    root = tmp_path_factory.mktemp("assets")
    (root / "pick_object_config.json").write_text(json.dumps({
        "offset": {"translation": [0, 0, 0.02]}, "min_dist": 0.03,
        "pick_config": [{"type": "segment", "point_a": [-0.02, 0, 0],
                         "point_b": [0.02, 0, 0]}]}))
    (root / "target_object_config.json").write_text(json.dumps({
        "offset": {"translation": [0, 0, 0.001]}, "min_dist": 0.03}))
    for fac, load, _ in SIDES.values():
        load.load_plugins(PLUGINS)
        fac.register_available_object("box", str(root))
    return root


@pytest.fixture
def seeded_valid_poses(monkeypatch):
    """`np.random.default_rng()` without a seed returns a generator seeded
    with 99, in both packages alike."""
    make = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: make(99 if seed is None else seed))


def _same(a, b):
    """Nested results of either package equal, Affines by their matrices,
    floats exactly."""
    if hasattr(a, "matrix"):
        np.testing.assert_array_equal(a.matrix, b.matrix)
    elif hasattr(a, "poses"):            # an Action
        assert a.type == b.type
        _same(list(a), list(b))
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _objects(objs):
    """What a task's objects are: type, pose, min-dist, ids, and the sizes
    and states of blocks, boards and targets."""
    return [(type(o).__name__, o.pose, o.min_dist, o.unique_id, o.object_id,
             o.urdf_path,
             *[getattr(o, k) for k in ("dimensions", "occupied", "static",
                                       "pick_config", "radius", "color")
               if hasattr(o, k)]) for o in objs]


def _task_state(task):
    return {"objectives": [(o.completed, o.object_unique_id,
                            o.target_unique_ids) for o in task.objectives],
            "manipulation": _objects(task.manipulation_objects),
            "targets": _objects(task.target_objects),
            "extra": _objects([getattr(task, k) for k in
                               ("box_block", "kitting_board")
                               if hasattr(task, k)]),
            "info": {k: v for k, v in task.get_info().items()
                     if isinstance(v, str)}}


def _factory_args(kind, seed):
    common = {"r_bounds": [[0, 0], [0, 0], [0, 2 * np.pi]], "rng": seed}
    if kind == "grasp":
        return {"task_factory_type": "grasp-task-factory",
                "t_bounds": [[0.3, 0.7], [-0.25, 0.25], [0, 0]],
                "object_types": ["box"], "n_objects": 3,
                "manipulation_type": "pick_object",
                "primitive_type": "pick-primitive", **common}
    if kind == "simple":
        return {"task_factory_type": "simple-task-factory",
                "t_bounds": [[0.2, 0.8], [-0.3, 0.3], [0, 0]],
                "object_types": ["box"], "n_objects": 2,
                "manipulation_type": "pick_object",
                "primitive_type": "pick-and-place-primitive",
                "target_object_type": "target", "target_type": "target_object",
                **common}
    if kind == "kitting":
        return {"task_factory_type": "kitting-task-factory",
                "t_bounds": [[0.0, 1.0], [-0.5, 0.5], [0, 0.1]],
                "object_types": ["box"], "manipulation_type": "pick_object",
                "primitive_type": "pick-and-place-primitive",
                "target_type": "target_object", **common}
    return {"task_factory_type": "box-packing-task-factory",
            "t_bounds": [[0.3, 0.7], [-0.25, 0.25], [0, 0]],
            "primitive_type": "pick-and-place-primitive", **common}


def _tasks(kind, seed, n=1):
    """`n` tasks from one seeded factory of `kind`, in each package."""
    out = {}
    for side, (fac, _, _) in SIDES.items():
        tf = fac.create_task_factory(_factory_args(kind, seed))
        out[side] = [tf.create_task() for _ in range(n)]
    return out


# ------------------------------------------------------------ the factory


def test_factory_registry_and_oracle(assets, seeded_valid_poses):
    """tests/test_data_tasks.py's factory and oracle test, in both
    packages: three non-overlapping pick objects, the suction oracle's
    pick pose scored 0 by its attention errors, one object grasped; the
    port's poses, errors and action those of the JAX package."""
    got = {}
    for side, (fac, _, _) in SIDES.items():
        task = fac.create_task_factory(_factory_args("grasp", 0)).create_task()
        assert len(task.manipulation_objects) == 3
        for i, a in enumerate(task.manipulation_objects):
            for b in task.manipulation_objects[i + 1:]:
                d = np.linalg.norm(a.pose.translation[:2]
                                   - b.pose.translation[:2])
                assert d >= a.min_dist + b.min_dist - 1e-9
        oracle = fac.create_oracle({"oracle_type": "suction_grasp-oracle",
                                    "gripper_offset": OFFSET, "rng": 0})
        action, solved = oracle.solve(task)
        errors = oracle.compute_attention_errors(task, action[0])
        assert errors[0][0] < 1e-6
        oracle.execute(action, task)
        assert len(task.manipulation_objects) == 2 and not solved
        got[side] = (list(action), errors, _task_state(task),
                     _objects(task.grasped_objects))
    _same(got["port"], got["jax"])


CREATORS = {
    "oracle": (factory.create_oracle, "oracle_type"),
    "task factory": (factory.create_task_factory, "task_factory_type"),
    "task": (factory.create_task, "task_type"),
    "primitive": (factory.create_primitive, "primitive_type"),
    "simulated scene": (factory.create_simulated_scene, "scene_type"),
    "sensor": (factory.create_sensor, "sensor_type"),
    "object": (lambda a: factory.create_object(a["object_type"], {}),
               "object_type"),
}


@pytest.mark.parametrize("kind", sorted(CREATORS))
def test_unknown_type_raises(kind):
    """An unregistered name raises the JAX package's ValueError, for every
    registry."""
    create, key = CREATORS[kind]
    with pytest.raises(ValueError, match=f"unknown {kind} type 'nope'"):
        create({key: "nope"})


def test_port_registries_are_its_own(assets):
    """A plugin registered in the port's factory is not in the JAX
    package's, and the other way round; a JAX package module name in a
    plugin list loads the port's plugin, any other `tcnerf.` module is
    refused."""
    factory.register_oracle("only-port", SuctionGraspOracle)
    try:
        with pytest.raises(ValueError, match="unknown oracle type"):
            jfactory.create_oracle({"oracle_type": "only-port",
                                    "gripper_offset": OFFSET})
        assert isinstance(factory.create_oracle(
            {"oracle_type": "only-port", "gripper_offset": OFFSET}),
            SuctionGraspOracle)
    finally:
        factory.unregister_oracle("only-port")
    assert loader.import_module("tcnerf.tasks.plugins.objects.base") is base
    assert loader.import_module(
        "manipulation_tasks.plugins.objects.base") is base
    with pytest.raises(ValueError, match="imports nothing of the JAX"):
        loader.import_module("tcnerf.tasks.agents")


def test_rectangle_pose_errors():
    """tests/test_data_tasks.py's hand-computed rectangle cases (plane
    projection, triangle-area containment, the edge tolerance, a yawed
    object) plus random gripper poses: the port's errors are the JAX
    package's bit for bit, and the hand values hold."""
    rect = {"type": "rectangle",
            "point_a": [-0.1, -0.05, 0.0], "point_b": [0.1, -0.05, 0.0],
            "point_c": [0.1, 0.05, 0.0], "point_d": [-0.1, 0.05, 0.0]}
    seg = {"type": "segment", "point_a": [-0.02, 0, 0],
           "point_b": [0.02, 0, 0.01]}
    rng = np.random.default_rng(7)
    grippers = [dict(translation=[0.0, 0.0, 0.02]),
                dict(translation=[0.2, 0.0, 0.03],
                     rotation=[np.pi / 6, 0.0, 0.0]),
                dict(translation=[0.5, 0.2, 0.15]),
                dict(translation=[0.1, 0.0, 0.04])] + [
        dict(translation=rng.uniform(-0.2, 0.6, 3),
             rotation=rng.uniform(-np.pi, np.pi, 3)) for _ in range(8)]
    for pose, symmetries in ((None, 1),
                             (dict(translation=[0.5, 0.2, 0.1],
                                   rotation=[0.0, 0.0, 0.7]), 2)):
        got, want = [], []
        for mod, aff, out in ((base, Affine, got), (jbase, JAffine, want)):
            kw = {} if pose is None else {"pose": aff(**pose)}
            obj = mod.PickObject(pick_config=[rect, seg], **kw)
            out += [obj.compute_pose_errors(aff(**g), symmetries)
                    for g in grippers]
        assert got == want
        if pose is None:
            (t, r), _ = got[0]
            assert abs(t - 0.02) < 1e-9 and abs(r) < 1e-9
            (t, r), _ = got[1]
            assert abs(t - np.sqrt(0.1 ** 2 + 0.03 ** 2)) < 1e-9
            assert abs(r - np.pi / 6) < 1e-9
            assert abs(got[3][0][0] - 0.04) < 1e-9
        else:
            (t, r), _ = got[2]
            assert abs(t - 0.05) < 1e-9 and abs(r) < 1e-9


def test_sphere_and_target_objects():
    """SphereObject's top-down valid pose and tilt error, TargetObject's
    symmetric valid poses and their errors, and the dataclass defaults."""
    rng = np.random.default_rng(8)
    poses = [dict(translation=rng.uniform(-1, 1, 3),
                  rotation=rng.uniform(-np.pi, np.pi, 3)) for _ in range(6)]
    out = {}
    for side, mod, aff in (("port", base, Affine), ("jax", jbase, JAffine)):
        sphere = mod.SphereObject(pose=aff(**poses[0]), radius=0.05)
        target = mod.TargetObject(pose=aff(**poses[1]),
                                  rotational_symmetries=3)
        out[side] = (sphere.min_dist, sphere.get_valid_poses(),
                     [sphere.compute_pose_errors(aff(**p)) for p in poses],
                     target.get_valid_poses(),
                     [target.compute_pose_errors(aff(**p)) for p in poses],
                     _objects([mod.SceneObject(), mod.PickObject()]))
    _same(out["port"], out["jax"])


# ------------------------------------------------------- task factories


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["grasp", "simple", "kitting",
                                  "box_packing"])
def test_task_factory_matches_jax(assets, kind, seed):
    """Two tasks from one seeded factory: every object's pose, min-dist,
    ids and sizes, the objectives and the task type are the JAX
    package's."""
    tasks = _tasks(kind, seed, n=2)
    for a, b in zip(tasks["port"], tasks["jax"]):
        assert a.objectives
        _same(_task_state(a), _task_state(b))


# ---------------------------------------------------------------- oracles


def _oracle_run(side, kind, oracle_type, seed):
    """Solve a task with the oracle, score the solution and a perturbed
    pose by every error function, execute it on a virtual scene (its
    logging robot records the primitive's motions), and solve again."""
    fac, _, aff = SIDES[side]
    task = fac.create_task_factory(_factory_args(kind, seed)).create_task()
    scene = fac.create_simulated_scene({"scene_type": "virtual-scene",
                                        "image_size": (12, 16), "rng": 0})
    task.setup(scene)
    oracle = fac.create_oracle({"oracle_type": oracle_type,
                                "gripper_offset": OFFSET, "rng": seed})
    action, solved = oracle.solve(task)
    nudge = aff(translation=[0.01, -0.02, 0.005], rotation=[0.1, 0.0, 0.3])
    out = [list(action), solved]
    for attention in (action[0], nudge * action[0]):
        out.append(oracle.compute_attention_errors(task, attention))
        out.append(oracle.compute_transport_errors(task, attention,
                                                   action[-1]))
        out.append(oracle.compute_transport_errors(task, attention,
                                                   nudge * action[-1]))
    if kind != "simple":
        # the grasp task keeps no scene ids of grasped objects: execute
        # without the scene there
        oracle.execute(action, task, None if kind == "grasp" else scene)
        out.append(oracle.solve(task))
    if kind != "grasp":
        out.append(oracle.compute_simulated_error(task, action[0], scene))
    out.append([tuple(c) for c in scene.robot.commands])
    out.append(_task_state(task))
    return out


@pytest.mark.parametrize("oracle_type,kind", [
    ("suction_grasp-oracle", "grasp"), ("suction_grasp-oracle", "simple"),
    ("insertion-oracle", "kitting"), ("insertion-oracle", "box_packing")])
def test_oracle_matches_jax(assets, seeded_valid_poses, oracle_type, kind):
    """The oracle's action and whether the task is solved, its attention
    and transport errors at the solution and at a perturbed pose, the
    executed primitive's motion commands, the next solution and the
    simulated error: the JAX package's."""
    _same(_oracle_run("port", kind, oracle_type, 3),
          _oracle_run("jax", kind, oracle_type, 3))


def test_insertion_places_every_object(assets, seeded_valid_poses):
    """The insertion oracle solves a kitting task to the end: five pick
    and place actions, each target occupied once, the last one solved."""
    task = _tasks("kitting", 4)["port"][0]
    oracle = factory.create_oracle({"oracle_type": "insertion-oracle",
                                    "gripper_offset": OFFSET, "rng": 1})
    solved = []
    for _ in range(5):
        action, done = oracle.solve(task)
        assert len(action) == 2
        oracle.execute(action, task)
        solved.append(done)
    assert solved == [False] * 4 + [True]
    assert all(t.occupied for t in task.target_objects)
    assert all(o.completed for o in task.objectives)


# ------------------------------------------------------- transform_utils


def _draws(seed, n=6):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(-1, 1, 3), rng.uniform(-1, 1, 3),
             rng.uniform(-1, 1, 3), rng.uniform(-np.pi, np.pi, 3))
            for _ in range(n)]


TRANSFORM_UTILS = {
    "rotation_to_line_difference": lambda m, aff, p, a, b, r:
        m.rotation_to_line_difference(aff(rotation=r).rotation, a, b),
    "point_to_segment_distance": lambda m, aff, p, a, b, r: (
        m.point_to_segment_distance(p, a, b),
        m.point_to_segment_distance(p, a, a)),
    "project_point_on_plane": lambda m, aff, p, a, b, r:
        m.project_point_on_plane(p, a, b),
    "triangle_area": lambda m, aff, p, a, b, r: m.triangle_area(p, a, b),
    "transformation_difference": lambda m, aff, p, a, b, r:
        m.transformation_difference(aff(translation=p, rotation=r),
                                    aff(translation=a, rotation=b)),
    "sample_point_from_segment": lambda m, aff, p, a, b, r:
        m.sample_point_from_segment(aff(translation=a), aff(translation=b),
                                    rng=3),
    "sample_pose_from_segment": lambda m, aff, p, a, b, r: (
        m.sample_pose_from_segment(aff(translation=a), aff(translation=b),
                                   rng=3),
        m.sample_pose_from_segment(aff(translation=a), aff(translation=a),
                                   rng=3),
        m.sample_pose_from_segment(aff(translation=a),
                                   aff(translation=a + [0, 0, 1]), rng=3)),
    "sample_pose_from_rectangle": lambda m, aff, p, a, b, r: (
        m.sample_pose_from_rectangle(
            aff(translation=a), aff(translation=b), aff(translation=p),
            aff(translation=a + p - b), rng=3),
        m.sample_pose_from_rectangle(
            aff(translation=a), aff(translation=a), aff(translation=p),
            aff(translation=p), rng=3)),
}


@pytest.mark.parametrize("name", sorted(TRANSFORM_UTILS))
def test_transform_utils_match_jax(name):
    """Each helper of transform_utils on six random draws (and its
    degenerate segment, rectangle and vertical cases): the JAX package's
    values bit for bit."""
    fn = TRANSFORM_UTILS[name]
    for p, a, b, r in _draws(len(name)):
        got = fn(differences if not name.startswith("sample") else random,
                 Affine, p, a, b, r)
        want = fn(jdiff if not name.startswith("sample") else jrandom,
                  JAffine, p, a, b, r)
        _same(got, want)


# --------------------------------------------------------- virtual scene


def test_virtual_scene_observation_matches_jax(assets):
    """VirtualScene over the port's SyntheticScene and camera_ring at
    48x64: every camera's image (RGBA), pose and intrinsics of the empty
    scene and of three spheres, one camera by name, and one after a sphere
    is removed; the logging robot's commands. Bit for bit the JAX
    package's."""
    out = {}
    for side, (fac, _, aff) in SIDES.items():
        scene = fac.create_simulated_scene({
            "scene_type": "virtual-scene", "n_perspectives": 3,
            "image_size": (48, 64), "rng": 2})
        empty = scene.get_observation("all")
        ids = [scene.add_object(fac.create_object("sphere_object", {
            "radius": 0.03 + 0.01 * k, "color": (0.2 * k, 0.5, 0.9),
            "pose": aff(translation=[0.45 + 0.1 * k, 0.05 * k, 0.05])}))
            for k in range(3)]
        scene.robot.home()
        scene.spawn_coordinate_frame(aff(translation=[0.5, 0, 0]))
        obs = empty + scene.get_observation("all") + scene.get_observation(
            "camera_1")
        scene.remove_objects(ids[:1])
        obs += scene.get_observation("camera_2")
        assert len(obs) == 8 and obs[0]["color"].shape == (48, 64, 4)
        scene.clean()
        out[side] = (obs, scene.get_object_pose(ids[1]),
                     scene.t_bounds, scene.r_bounds, scene.robot.commands)
        scene.shutdown()
    _same(out["port"], out["jax"])


# -------------------------------------------------------------- collection


def _same_files(got_root, want_root):
    names = _tree(want_root)
    assert names and names == _tree(got_root)
    for name in names:
        a, b = got_root / name, want_root / name
        if name.endswith(".pkl"):
            assert a.read_bytes() == b.read_bytes(), name
        else:
            with np.load(a) as za, np.load(b) as zb:
                assert sorted(za.keys()) == sorted(zb.keys())
                for k in za.keys():
                    np.testing.assert_array_equal(za[k], zb[k])
    return names


@pytest.mark.parametrize("layout", ["default", "dict_records",
                                    "record_order"])
def test_collect_grasp_dataset_matches_jax(tmp_path, layout):
    """collect_grasp_dataset at 48x64, 3 samples of 5 perspectives and 3
    objects: the same file names, pickles byte for byte and npz arrays bit
    for bit as the JAX package's, and the factory's
    `create_manipulation_object` restored afterwards."""
    kw = dict(n_samples=3, image_size=(48, 64), rng=4)
    if layout != "default":
        kw[layout] = True
    original = factory.create_manipulation_object
    jcollect.collect_grasp_dataset(str(tmp_path / "j"), **kw)
    collect.collect_grasp_dataset(str(tmp_path / "p"), **kw)
    assert factory.create_manipulation_object is original
    names = _same_files(tmp_path / "p", tmp_path / "j")
    assert ("order/sample_00000002.npz" in names) == (layout ==
                                                      "record_order")
    assert len(names) == 3 * (6 + (layout == "record_order"))


def test_collect_main_takes_the_jax_arguments(tmp_path, monkeypatch):
    """`python -m tcnerf_torch.data.collect` with the JAX CLI's arguments
    writes the JAX CLI's files."""
    args = ["--n-samples", "2", "--n-perspectives", "2", "--n-objects",
            "2", "--height", "24", "--width", "32", "--seed", "5",
            "--dict-records"]
    monkeypatch.setattr("sys.argv", ["collect", str(tmp_path / "j"), *args])
    jcollect.main()
    collect.main([str(tmp_path / "p"), *args])
    names = _same_files(tmp_path / "p", tmp_path / "j")
    assert len(names) == 2 * 6


# ------------------------------------------------------------ validation


def _valid_data(n=2):
    rng = np.random.default_rng(9)
    out = []
    for _ in range(n):
        gt = Affine(translation=rng.uniform(0.3, 0.6, 3),
                    rotation=rng.uniform(-np.pi, np.pi, 3)).matrix
        out.append(([None] * 4, None, {"object_0": {}}, gt))
    return out


def test_validate_with_the_suction_oracle_matches_jax():
    """`validate` (and so `get_step_results`) with the suction oracle,
    which has no `calculate_error`: scored through `OracleAgent` as in the
    JAX package, the same poses, energies and errors as the JAX function's
    and as the port's with `OracleAgent` itself."""
    config_ = {"n_optimization_steps": 2, "init_lr_t": 0.1, "decay_t": 0.9,
               "sync": True}
    oracles = {}
    for name, (fac, load, _) in SIDES.items():
        load.load_plugins(["suction_grasp"])
        oracles[name] = fac.create_oracle({
            "oracle_type": "suction_grasp-oracle", "gripper_offset": OFFSET})
    assert not hasattr(oracles["port"], "calculate_error")
    results = {}
    for name, module, opt, oracle in (
            ("jax", jsession, FakeOptimizer, oracles["jax"]),
            ("port", session, PortFake, oracles["port"]),
            ("agent", session, PortFake, agents.OracleAgent())):
        fake = opt([0.5, 0.0, 0.1])
        fake.quality = 0.5
        results[name] = module.validate(fake, config_, _valid_data(),
                                        oracle=oracle, rng=0)
    for got in (results["port"], results["agent"]):
        assert len(got) == 2
        for a, b in zip(got, results["jax"]):
            _same(a["grasp_poses"], b["grasp_poses"])
            assert a["final_success"] == b["final_success"]
            assert a["errors_r"] == b["errors_r"]
    losses = np.random.default_rng(5).normal(size=12)
    poses = [Affine(translation=t) for t in
             np.random.default_rng(6).uniform(0, 1, (12, 3))]
    gt = _valid_data(1)[0][3]
    got = session.get_step_results(losses, poses, gt, oracles["port"])
    want = jsession.get_step_results(
        losses, [JAffine(translation=p.translation) for p in poses], gt,
        oracles["jax"])
    assert got["errors_r"] == want["errors_r"]
    assert got["final_success"] == want["final_success"]


def test_build_oracle_from_the_composed_config():
    """`build_oracle` of the port's composed goal_1_view config (its
    plugins named by the JAX package's modules) is the port's suction
    oracle with the JAX `setup_oracle`'s gripper offset; without an oracle
    config `setup_oracle` gives an `OracleAgent`."""
    oracle = grasp_common.build_oracle(config.load_config([], "goal_1_view"))
    jcfg = jconfig.load_config(JCONFIGS, "goal_1_view", [])
    want = jagents.setup_oracle(jcfg.validation.plugins,
                                jcfg.validation.oracle)
    assert type(oracle) is SuctionGraspOracle
    np.testing.assert_array_equal(oracle.gripper_offset.matrix,
                                  want.gripper_offset.matrix)
    assert isinstance(agents.setup_oracle(["objects"]), agents.OracleAgent)
    assert isinstance(agents.setup_oracle(), agents.OracleAgent)
