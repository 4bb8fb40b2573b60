"""Plugin registries for tasks, oracles, primitives, objects, scenes, sensors
(tcnerf/tasks/factory.py).

API parity with the reference's manipulation_tasks.factory
(dependencies/manipulation_tasks/manipulation_tasks/factory.py:11-201) —
register_X / unregister_X / create_X for each kind, plus URDF/config-driven
object instantiation — implemented as one generic registry rather than six
copies of the same pattern. The registries are this module's own: a plugin
registered here is not registered in the JAX package, and the other way
round.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict

from .transform import Affine


class Registry:
    def __init__(self, kind: str, type_key: str):
        self.kind = kind
        self.type_key = type_key
        self._creators: Dict[str, Callable] = {}

    def register(self, name: str, creator_fn: Callable) -> None:
        self._creators[name] = creator_fn

    def unregister(self, name: str) -> None:
        self._creators.pop(name, None)

    def create(self, arguments: Dict[str, Any]):
        args = dict(arguments)
        name = args.pop(self.type_key)
        try:
            creator = self._creators[name]
        except KeyError:
            raise ValueError(f"unknown {self.kind} type {name!r}") from None
        return creator(**args)

    def create_by_name(self, name: str, **kwargs):
        try:
            creator = self._creators[name]
        except KeyError:
            raise ValueError(f"unknown {self.kind} type {name!r}") from None
        return creator(**kwargs)


_tasks = Registry("task", "task_type")
_task_factories = Registry("task factory", "task_factory_type")
_oracles = Registry("oracle", "oracle_type")
_primitives = Registry("primitive", "primitive_type")
_objects = Registry("object", "object_type")
_simulated_scenes = Registry("simulated scene", "scene_type")
_sensors = Registry("sensor", "sensor_type")

available_object_paths: Dict[str, str] = {}

# ------------------------------------------------------------- public API

register_task = _tasks.register
unregister_task = _tasks.unregister
create_task = _tasks.create

register_task_factory = _task_factories.register
unregister_task_factory = _task_factories.unregister
create_task_factory = _task_factories.create

register_oracle = _oracles.register
unregister_oracle = _oracles.unregister
create_oracle = _oracles.create

register_primitive = _primitives.register
unregister_primitive = _primitives.unregister
create_primitive = _primitives.create

register_object = _objects.register
unregister_object = _objects.unregister

register_simulated_scene = _simulated_scenes.register
unregister_simulated_scene = _simulated_scenes.unregister
create_simulated_scene = _simulated_scenes.create

register_sensor = _sensors.register
unregister_sensor = _sensors.unregister
create_sensor = _sensors.create


def create_object(o_type: str, arguments: Dict[str, Any]):
    return _objects.create_by_name(o_type, **arguments)


def register_available_object(object_type: str, resources_path: str) -> None:
    available_object_paths[object_type] = resources_path


def unregister_available_object(object_type: str) -> None:
    available_object_paths.pop(object_type, None)


def create_object_args_dict(manipulation_type: str, object_type: str, urdf):
    """Assemble object kwargs from the on-disk `<type>_config.json`
    (reference factory.py:152-164)."""
    config_file = f"{available_object_paths[object_type]}/{manipulation_type}_config.json"
    with open(config_file) as f:
        additional_args = json.load(f)
    additional_args["offset"] = Affine(**additional_args["offset"])
    kwargs = {"urdf_path": urdf, "object_id": -1}
    kwargs.update(additional_args)
    return kwargs


def create_manipulation_object(object_type: str, manipulation_type: str):
    urdf = f"{available_object_paths[object_type]}/object.urdf"
    return create_object(manipulation_type,
                         create_object_args_dict(manipulation_type, object_type, urdf))


def create_target_object(object_type: str, target_object_type, target_type: str):
    urdf = (f"{available_object_paths[object_type]}/{target_object_type}.urdf"
            if target_object_type is not None else None)
    return create_object(target_type,
                         create_object_args_dict(target_type, object_type, urdf))
