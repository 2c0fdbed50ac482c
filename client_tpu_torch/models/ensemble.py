"""Ensemble models: a DAG of member models executed server-side.

The counterpart of ``client_tpu.models.ensemble``: an ensemble is itself a
Model whose execute() walks its steps through the server's registry
(``ServerCore.add_model`` binds it), so clients use it like any other model.
Tensors flow between the steps as the members return them: device tensors
stay on the device from one stage to the next.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

from .base import Model, TensorSpec


class EnsembleStep:
    """One pipeline stage: run ``model_name`` with renamed inputs/outputs.

    ``input_map``: ensemble-tensor-name -> member-model input name.
    ``output_map``: member-model output name -> ensemble-tensor-name.
    """

    def __init__(self, model_name: str, input_map: Dict[str, str], output_map: Dict[str, str]):
        self.model_name = model_name
        self.input_map = input_map
        self.output_map = output_map


class EnsembleModel(Model):
    """A sequential ensemble over registered member models."""

    platform = "ensemble"

    def __init__(self, name: str, steps: Sequence[EnsembleStep],
                 inputs: Sequence[TensorSpec], outputs: Sequence[TensorSpec]):
        super().__init__()
        self.name = name
        self._steps = list(steps)
        self._inputs = list(inputs)
        self._outputs = list(outputs)
        # bound by ServerCore.add_model so steps resolve against the registry
        self._resolver: Optional[Callable[[str], Model]] = None

    def bind(self, resolver: Callable[[str], Model]) -> None:
        self._resolver = resolver

    def inputs(self) -> List[TensorSpec]:
        return list(self._inputs)

    def outputs(self) -> List[TensorSpec]:
        return list(self._outputs)

    def labels(self):
        # classification labels come from the final step's model
        if self._resolver is None or not self._steps:
            return None
        return self._resolver(self._steps[-1].model_name).labels()

    def config(self) -> Dict[str, Any]:
        cfg = super().config()
        cfg["platform"] = "ensemble"
        cfg["ensemble_scheduling"] = {
            "step": [
                {
                    "model_name": s.model_name,
                    "model_version": -1,
                    # Triton's proto orientation: key = member model tensor
                    # name, value = ensemble-scoped tensor name (both maps)
                    "input_map": {m: e for e, m in s.input_map.items()},
                    "output_map": s.output_map,
                }
                for s in self._steps
            ]
        }
        return cfg

    def execute(self, inputs: Dict[str, Any], parameters: Dict[str, Any]):
        if self._resolver is None:
            raise RuntimeError(f"ensemble '{self.name}' is not bound to a model registry")
        # the tensor pool flows ensemble-scoped names through the steps
        pool: Dict[str, Any] = dict(inputs)
        for step in self._steps:
            member = self._resolver(step.model_name)
            member_inputs = {}
            for pool_name, member_name in step.input_map.items():
                if pool_name not in pool:
                    raise ValueError(
                        f"ensemble '{self.name}' step '{step.model_name}': "
                        f"tensor '{pool_name}' not produced by any prior step")
                member_inputs[member_name] = pool[pool_name]
            member_outputs = member.execute(member_inputs, parameters)
            for member_name, pool_name in step.output_map.items():
                if member_name not in member_outputs:
                    raise ValueError(
                        f"ensemble '{self.name}' step '{step.model_name}': "
                        f"model produced no output '{member_name}'")
                pool[pool_name] = member_outputs[member_name]
        missing = [spec.name for spec in self._outputs if spec.name not in pool]
        if missing:
            raise ValueError(
                f"ensemble '{self.name}': declared outputs {missing} were not "
                "produced by any step's output_map")
        return {spec.name: pool[spec.name] for spec in self._outputs}


def build_image_ensemble(num_classes: int = 1000, width: int = 32, tensor_parallel: int = 1,
                         device="cuda") -> List[Model]:
    """The ensemble_image pipeline: [preprocess, densenet_onnx, ensemble].

    Register all three; clients send a raw UINT8 HWC "IMAGE" to
    ``ensemble_image`` and get "CLASSIFICATION" (densenet logits) back.
    """
    from .vision import DenseNetModel, ImagePreprocessModel

    preprocess = ImagePreprocessModel(device=device)
    densenet = DenseNetModel(num_classes=num_classes, width=width,
                             tensor_parallel=tensor_parallel, device=device)
    ensemble = EnsembleModel(
        "ensemble_image",
        steps=[
            EnsembleStep("preprocess", {"IMAGE": "raw_image"}, {"preprocessed": "stage0"}),
            EnsembleStep("densenet_onnx", {"stage0": "data_0"}, {"fc6_1": "CLASSIFICATION"}),
        ],
        inputs=[TensorSpec("IMAGE", "UINT8", [-1, -1, 3])],
        outputs=[TensorSpec("CLASSIFICATION", "FP32", [num_classes, 1, 1])],
    )
    return [preprocess, densenet, ensemble]
