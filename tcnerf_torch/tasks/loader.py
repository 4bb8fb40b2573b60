"""Plugin loading (tcnerf/tasks/loader.py, after the reference's
manipulation_tasks/loader.py:7-31).

A plugin is named by a short name (`grasp_task`), by a module of this
package (`tcnerf_torch.tasks.plugins.tasks.grasp_task`), or by the module
the reference (`manipulation_tasks.plugins.*`) or the JAX package
(`tcnerf.tasks.plugins.*`, as the composed configs carry them) gives it;
the last two resolve to this package's plugin of the same path, so loading
a plugin never imports the JAX package.
"""

from __future__ import annotations

import importlib
import os
from typing import Dict, List

from . import factory

_PLUGINS = "tcnerf_torch.tasks.plugins"
# Short names for the built-in plugins so configs can say 'grasp_task' instead
# of the full module path; full module paths also work.
_BUILTIN_PLUGINS = {
    "grasp_task": f"{_PLUGINS}.tasks.grasp_task",
    "simple_task": f"{_PLUGINS}.tasks.simple_task",
    "box_packing_task": f"{_PLUGINS}.tasks.box_packing_task",
    "kitting_task": f"{_PLUGINS}.tasks.kitting_task",
    "suction_grasp": f"{_PLUGINS}.oracles.suction_grasp",
    "insertion": f"{_PLUGINS}.oracles.insertion",
    "pick_and_place": f"{_PLUGINS}.primitives.pick_and_place",
    "objects": f"{_PLUGINS}.objects.base",
    "virtual_scene": f"{_PLUGINS}.scenes.virtual",
}
# the reference's and the JAX package's plugin packages
_ALIASES = ("manipulation_tasks.plugins", "tcnerf.tasks.plugins")


def import_module(name: str):
    name = _BUILTIN_PLUGINS.get(name, name)
    for alias in _ALIASES:
        if name == alias or name.startswith(alias + "."):
            name = _PLUGINS + name[len(alias):]
    if name.split(".")[0] == "tcnerf":
        raise ValueError(f"plugin {name!r} is not a task plugin: this "
                         "package imports nothing of the JAX package")
    return importlib.import_module(name)


def load_plugins(plugins: List[str]) -> None:
    for plugin_file in plugins:
        import_module(plugin_file).register()


def add_available_objects(objects: Dict[str, str], root: str = None) -> None:
    for key, value in objects.items():
        if root is not None:
            value = os.path.join(root, value)
        factory.register_available_object(key, value)
