"""Typed parser for graph-construction pipeline specs
(reference: graph_pipeline.rs).

Grammar: `stage[,key=value...][:stage[,key=value...]]...` — e.g.
`gfa:cut-n=100:poa:sort`.  The parser validates syntax and normalizes
names; runtime dispatch stays in the command layer.

The port's copy of impg_tpu/graph/pipeline.py, with its error texts
(tests/test_torch_graph_pipeline.py holds the parse equal).
"""

from __future__ import annotations

from dataclasses import dataclass, field


def _normalize_name(raw: str) -> str:
    return raw.strip().lower().replace("_", "-")


@dataclass
class GraphPipelineStage:
    name: str
    params: list[tuple[str, str]] = field(default_factory=list)
    # Inline stage value for `name=value` heads (reference grammar:
    # `gfa:cut-n=100:pggb:crush`, main.rs:164 shorthand expansion).
    value: str | None = None

    @classmethod
    def parse(cls, raw: str, stage_idx: int) -> "GraphPipelineStage":
        pieces = [p.strip() for p in raw.split(",")]
        head = pieces[0]
        head_value = None
        if "=" in head:
            head, _, hv_raw = head.partition("=")
            head_value = hv_raw.strip() or None
        name = _normalize_name(head)
        if not name:
            raise ValueError(f"empty stage name at position {stage_idx + 1}")
        params: list[tuple[str, str]] = []
        seen = set()
        for piece in pieces[1:]:
            if not piece:
                raise ValueError(f"stage '{name}' has an empty parameter")
            if "=" not in piece:
                raise ValueError(
                    f"stage '{name}' parameter '{piece}' must be key=value"
                )
            key_raw, value_raw = piece.split("=", 1)
            key = _normalize_name(key_raw)
            value = value_raw.strip()
            if not key:
                raise ValueError(f"stage '{name}' has an empty parameter key")
            if not value:
                raise ValueError(
                    f"stage '{name}' parameter '{key}' has empty value"
                )
            if key in seen:
                raise ValueError(f"stage '{name}' repeats parameter '{key}'")
            seen.add(key)
            params.append((key, value))
        return cls(name=name, params=params, value=head_value)

    def param(self, key: str):
        key = _normalize_name(key)
        for k, v in self.params:
            if k == key:
                return v
        return None

    def to_spec(self) -> str:
        head = self.name if self.value is None else f"{self.name}={self.value}"
        parts = [head] + [f"{k}={v}" for k, v in self.params]
        return ",".join(parts)


@dataclass
class GraphPipelineSpec:
    stages: list[GraphPipelineStage]

    @classmethod
    def parse(cls, raw: str) -> "GraphPipelineSpec":
        raw = raw.strip()
        if not raw:
            raise ValueError("empty graph pipeline spec")
        stages = []
        for stage_idx, raw_stage in enumerate(raw.split(":")):
            raw_stage = raw_stage.strip()
            if not raw_stage:
                raise ValueError(f"empty stage at position {stage_idx + 1}")
            stages.append(GraphPipelineStage.parse(raw_stage, stage_idx))
        return cls(stages=stages)

    def to_spec(self) -> str:
        return ":".join(s.to_spec() for s in self.stages)

    def stages_from(self, start: int) -> "GraphPipelineSpec":
        return GraphPipelineSpec(stages=self.stages[start:])
