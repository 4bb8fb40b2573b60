"""The program's configuration as a configuration file states it.

A file under `configs/` names the port's composed config (`port.name`) and
maps each of its own sizes to the port's key (`port.keys`); every mapped
size is passed to the port as an override, so the run uses the file's
numbers, and `port.overrides` adds any other setting.
"""

from __future__ import annotations

import json
from typing import List


def overrides(config: dict) -> List[str]:
    port = config["port"]
    out = [f"{path}={json.dumps(config[key])}"
           for key, path in port.get("keys", {}).items()]
    return out + list(port.get("overrides", []))


def load(config: dict):
    from tcnerf_torch.train.config import load_config
    return load_config(overrides(config), config["port"]["name"])
