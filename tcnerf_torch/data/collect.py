"""End-to-end demonstration collection through the task framework
(tcnerf/data/collect.py).

The reference's data-collection scripts live in missing submodules
(SURVEY.md §2.9/§2.10). This module closes the loop natively: a grasp task is
instantiated through the plugin factory, set up in a VirtualScene, observed
from the scene's posed cameras, solved by the suction-grasp oracle, and the
resulting (images, camera configs, grasp pose, approach trajectory, language,
info) records are written in the tcnerf dataset layout — directly consumable
by every data generator and loader. Host-only (numpy + scipy); for the same
seed it writes the same files as the JAX package.

Usage: python -m tcnerf_torch.data.collect path/to/out --n-samples 16
       [--n-perspectives 5] [--n-objects 3] [--height 480] [--width 640]
       [--seed 0] [--dict-records]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..tasks import factory, loader
from .dataset import ColorDataset, NPZDataset, PickleDataset
from .synthetic import _COLOR_NAMES, color_name, grasp_trajectory


def collect_grasp_dataset(root: str, n_samples: int, n_perspectives: int = 5,
                          n_objects: int = 3, image_size=(480, 640), rng=0,
                          dict_records: bool = False, record_order: bool = False):
    """Write `n_samples` solved grasp tasks under `root`: per sample the
    scene's seed, the task factory's seed, each object's colour and radius,
    and the oracle's seed are drawn from `rng` in this order, as the JAX
    function draws them. `dict_records` writes the grasp pose and the
    trajectory as dict records (the language datasets' flavour),
    `record_order` the trajectory's length."""
    rng = np.random.default_rng(rng)
    loader.load_plugins(["objects", "pick_and_place", "grasp_task",
                         "suction_grasp", "virtual_scene"])

    names = list(_COLOR_NAMES)
    os.makedirs(root, exist_ok=True)
    for i in range(n_samples):
        scene = factory.create_simulated_scene({
            "scene_type": "virtual-scene", "n_perspectives": n_perspectives,
            "image_size": image_size, "rng": int(rng.integers(2 ** 31))})

        task_factory = factory.create_task_factory({
            "task_factory_type": "grasp-task-factory",
            "t_bounds": scene.t_bounds.tolist(),
            "r_bounds": [[0, 0], [0, 0], [0, 2 * np.pi]],
            "object_types": ["sphere_object"], "n_objects": n_objects,
            "manipulation_type": "sphere_object",
            "primitive_type": "pick-primitive",
            "rng": int(rng.integers(2 ** 31))})
        # sphere objects are procedural — no asset path lookup
        factory.register_available_object("sphere_object", "")
        original_create = factory.create_manipulation_object

        def create_sphere(object_type, manipulation_type):
            color = _COLOR_NAMES[names[int(rng.integers(len(names)))]]
            return factory.create_object("sphere_object", {
                "radius": float(rng.uniform(0.03, 0.06)), "color": color})

        factory.create_manipulation_object = create_sphere
        try:
            task = task_factory.create_task()
        finally:
            factory.create_manipulation_object = original_create

        task.setup(scene)

        oracle = factory.create_oracle({
            "oracle_type": "suction_grasp-oracle",
            "gripper_offset": {"rotation": [np.pi, 0.0, np.pi / 2]},
            "rng": int(rng.integers(2 ** 31))})
        action, _solved = oracle.solve(task)
        grasp_pose = action[0].matrix
        target_object = oracle.selected_object

        observations = scene.get_observation("all")
        colors = np.stack([obs["color"] for obs in observations])
        configs = [{"pose": obs["pose"], "intrinsics": obs["intrinsics"]}
                   for obs in observations]
        traj = grasp_trajectory(grasp_pose)
        lang = f"grasp the {color_name(target_object.color)} ball"
        info = {
            f"object_{o.unique_id}": {
                "position": list(o.pose.translation),
                "radius": float(o.radius),
                "color": list(o.color),
                "is_target": bool(o.unique_id == target_object.unique_id),
            } for o in task.manipulation_objects
        }

        ColorDataset.write_sample(os.path.join(root, "color"), i, colors)
        PickleDataset.write_sample(os.path.join(root, "camera_config"), i, configs)
        if dict_records:
            PickleDataset.write_sample(os.path.join(root, "grasp_pose"), i,
                                       {"grasp_pose": grasp_pose})
            PickleDataset.write_sample(os.path.join(root, "trajectory"), i,
                                       {"trajectory": traj})
        else:
            NPZDataset.write_sample(os.path.join(root, "grasp_pose"), i,
                                    grasp_pose)
            PickleDataset.write_sample(os.path.join(root, "trajectory"), i, traj)
        PickleDataset.write_sample(os.path.join(root, "language"), i, lang)
        PickleDataset.write_sample(os.path.join(root, "info"), i, info)
        if record_order:
            NPZDataset.write_sample(os.path.join(root, "order"), i,
                                    np.asarray(len(traj)))
    return root


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("root")
    parser.add_argument("--n-samples", type=int, default=8)
    parser.add_argument("--n-perspectives", type=int, default=5)
    parser.add_argument("--n-objects", type=int, default=3)
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dict-records", action="store_true")
    args = parser.parse_args(argv)
    collect_grasp_dataset(args.root, args.n_samples, args.n_perspectives,
                          args.n_objects, (args.height, args.width), args.seed,
                          args.dict_records)


if __name__ == "__main__":
    main()
