"""External run configuration.

Counterpart of OpParams (reference: features/.../OpParams.scala:81-95,
applied at OpWorkflow.scala:166-188): JSON-loadable run config enabling
out-of-code injection of stage params (by class name or uid), reader
paths/params, and output locations.

Host copy of ``transmogrifai_tpu/workflow/params.py``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class OpParams:
    stage_params: dict[str, dict[str, Any]] = field(default_factory=dict)
    reader_params: dict[str, dict[str, Any]] = field(default_factory=dict)
    model_location: Optional[str] = None
    write_location: Optional[str] = None
    write_format: str = "json"  # "json" | "avro" (reference saves avro)
    metrics_location: Optional[str] = None
    custom_params: dict[str, Any] = field(default_factory=dict)

    @staticmethod
    def from_file(path: str) -> "OpParams":
        with open(path) as f:
            return OpParams.from_json(json.load(f))

    @staticmethod
    def from_json(d: dict) -> "OpParams":
        return OpParams(
            stage_params=d.get("stageParams", d.get("stage_params", {})),
            reader_params=d.get("readerParams", d.get("reader_params", {})),
            model_location=d.get("modelLocation", d.get("model_location")),
            write_location=d.get("writeLocation", d.get("write_location")),
            write_format=d.get("writeFormat", d.get("write_format", "json")),
            metrics_location=d.get("metricsLocation", d.get("metrics_location")),
            custom_params=d.get("customParams", d.get("custom_params", {})),
        )

    def to_json(self) -> dict:
        return {
            "stageParams": self.stage_params,
            "readerParams": self.reader_params,
            "modelLocation": self.model_location,
            "writeLocation": self.write_location,
            "writeFormat": self.write_format,
            "metricsLocation": self.metrics_location,
            "customParams": self.custom_params,
        }

    def apply_to_dag(self, dag) -> list[str]:
        """Inject stage params by class name or uid (reference:
        OpWorkflow.scala:166-188).  Returns the uids touched."""
        from .dag import flatten

        touched = []
        for stage in flatten(dag):
            for key, params in self.stage_params.items():
                if key == stage.uid or key == type(stage).__name__:
                    stage.set(**params)
                    for k, v in params.items():
                        if hasattr(stage, k) and not callable(getattr(stage, k)):
                            setattr(stage, k, v)
                    touched.append(stage.uid)
        return touched
