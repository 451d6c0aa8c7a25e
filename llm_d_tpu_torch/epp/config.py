"""EndpointPickerConfig: the EPP's declarative plugin-graph schema (port
of ``llm_d_tpu.epp.config``: the same schema, the same parse and the
same default).

Mirrors the reference scheduler's config format so existing plugin YAML
carries over nearly verbatim (reference:
guides/precise-prefix-cache-aware/gaie-kv-events/values.yaml:42-70,
guides/pd-disaggregation/gaie-pd/values.yaml:13-45):

    apiVersion: inference.networking.x-k8s.io/v1alpha1
    kind: EndpointPickerConfig
    plugins:
    - type: queue-scorer
    - type: kv-cache-utilization-scorer
    - type: prefix-cache-scorer
      parameters: {lruCapacityPerServer: 31250, hashBlockSize: 64}
    - type: max-score-picker
    - type: single-profile-handler
    schedulingProfiles:
    - name: default
      plugins:
      - pluginRef: queue-scorer
        weight: 2
      - pluginRef: prefix-cache-scorer
        weight: 3
      - pluginRef: max-score-picker

A plugin may carry ``name:`` to instantiate the same type twice with
different parameters (the tiered-cache guide instantiates gpu-/cpu- prefix
scorers this way; reference: tiered inferencepool/values.yaml:23-29).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import yaml


@dataclasses.dataclass
class PluginSpec:
    type: str
    name: str                       # defaults to type
    parameters: Dict[str, Any]


@dataclasses.dataclass
class ProfilePluginRef:
    plugin_ref: str
    weight: float = 1.0


@dataclasses.dataclass
class SchedulingProfile:
    name: str
    plugins: List[ProfilePluginRef]


@dataclasses.dataclass
class EndpointPickerConfig:
    plugins: List[PluginSpec]
    profiles: List[SchedulingProfile]

    def plugin(self, name: str) -> Optional[PluginSpec]:
        for p in self.plugins:
            if p.name == name:
                return p
        return None

    def profile(self, name: str) -> Optional[SchedulingProfile]:
        for p in self.profiles:
            if p.name == name:
                return p
        return None


def parse_config(text: str) -> EndpointPickerConfig:
    doc = yaml.safe_load(text) or {}
    kind = doc.get("kind", "EndpointPickerConfig")
    if kind != "EndpointPickerConfig":
        raise ValueError(f"unexpected kind {kind!r}")
    plugins = [
        PluginSpec(
            type=p["type"],
            name=p.get("name", p["type"]),
            parameters=p.get("parameters") or {},
        )
        for p in doc.get("plugins", [])
    ]
    profiles = [
        SchedulingProfile(
            name=pr.get("name", "default"),
            plugins=[
                ProfilePluginRef(
                    plugin_ref=r["pluginRef"],
                    weight=float(r.get("weight", 1.0)))
                for r in pr.get("plugins", [])
            ],
        )
        for pr in doc.get("schedulingProfiles", [])
    ]
    if not profiles:
        # Default profile referencing every configured plugin at weight 1.
        profiles = [SchedulingProfile(
            name="default",
            plugins=[ProfilePluginRef(p.name) for p in plugins])]
    return EndpointPickerConfig(plugins=plugins, profiles=profiles)


DEFAULT_CONFIG_YAML = """
apiVersion: inference.networking.x-k8s.io/v1alpha1
kind: EndpointPickerConfig
plugins:
- type: single-profile-handler
- type: drain-filter
- type: circuit-breaker-filter
- type: queue-scorer
- type: kv-cache-utilization-scorer
- type: prefix-cache-scorer
  parameters:
    hashBlockSize: 64
    lruCapacityPerServer: 31250
- type: max-score-picker
schedulingProfiles:
- name: default
  plugins:
  - pluginRef: drain-filter
  - pluginRef: circuit-breaker-filter
  - pluginRef: queue-scorer
    weight: 2
  - pluginRef: kv-cache-utilization-scorer
    weight: 2
  - pluginRef: prefix-cache-scorer
    weight: 3
  - pluginRef: max-score-picker
"""
