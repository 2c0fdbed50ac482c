"""Message specs for ``inference.GRPCInferenceService`` (KServe v2 GRPC).

Field numbers follow the public KServe/Triton protocol definition (reference:
src/rust/triton-client/proto/grpc_service.proto — service :40, ModelInfer
messages :575-820, shm messages :1403-1460, trace/log :1660-1737;
model_config.proto for the ModelConfig subset) so the wire format
interoperates with any v2 server. The codec is ``_wire.py``.

An own copy of ``client_tpu.grpc._messages``, spec for spec. The Tpu
shared-memory rpcs stay in the table so the codec decodes any frame of the
JAX package's server; the port's own server answers them UNIMPLEMENTED.
"""

from __future__ import annotations

from ._wire import MessageSpec, map_field, message, scalar

# ---------------------------------------------------------------------------
# shared sub-messages
# ---------------------------------------------------------------------------

INFER_PARAMETER = MessageSpec(
    "InferParameter",
    [
        scalar("bool_param", 1, "bool", oneof="parameter_choice"),
        scalar("int64_param", 2, "int64", oneof="parameter_choice"),
        scalar("string_param", 3, "string", oneof="parameter_choice"),
        scalar("double_param", 4, "double", oneof="parameter_choice"),
        scalar("uint64_param", 5, "uint64", oneof="parameter_choice"),
    ],
)

INFER_TENSOR_CONTENTS = MessageSpec(
    "InferTensorContents",
    [
        scalar("bool_contents", 1, "bool", repeated=True),
        scalar("int_contents", 2, "int32", repeated=True),
        scalar("int64_contents", 3, "int64", repeated=True),
        scalar("uint_contents", 4, "uint32", repeated=True),
        scalar("uint64_contents", 5, "uint64", repeated=True),
        scalar("fp32_contents", 6, "float", repeated=True),
        scalar("fp64_contents", 7, "double", repeated=True),
        scalar("bytes_contents", 8, "bytes", repeated=True),
    ],
)

INFER_INPUT_TENSOR = MessageSpec(
    "ModelInferRequest.InferInputTensor",
    [
        scalar("name", 1, "string"),
        scalar("datatype", 2, "string"),
        scalar("shape", 3, "int64", repeated=True),
        map_field("parameters", 4, "string", INFER_PARAMETER),
        message("contents", 5, INFER_TENSOR_CONTENTS),
    ],
)

INFER_REQUESTED_OUTPUT_TENSOR = MessageSpec(
    "ModelInferRequest.InferRequestedOutputTensor",
    [
        scalar("name", 1, "string"),
        map_field("parameters", 2, "string", INFER_PARAMETER),
    ],
)

MODEL_INFER_REQUEST = MessageSpec(
    "ModelInferRequest",
    [
        scalar("model_name", 1, "string"),
        scalar("model_version", 2, "string"),
        scalar("id", 3, "string"),
        map_field("parameters", 4, "string", INFER_PARAMETER),
        message("inputs", 5, INFER_INPUT_TENSOR, repeated=True),
        message("outputs", 6, INFER_REQUESTED_OUTPUT_TENSOR, repeated=True),
        scalar("raw_input_contents", 7, "bytes", repeated=True),
    ],
)

INFER_OUTPUT_TENSOR = MessageSpec(
    "ModelInferResponse.InferOutputTensor",
    [
        scalar("name", 1, "string"),
        scalar("datatype", 2, "string"),
        scalar("shape", 3, "int64", repeated=True),
        map_field("parameters", 4, "string", INFER_PARAMETER),
        message("contents", 5, INFER_TENSOR_CONTENTS),
    ],
)

MODEL_INFER_RESPONSE = MessageSpec(
    "ModelInferResponse",
    [
        scalar("model_name", 1, "string"),
        scalar("model_version", 2, "string"),
        scalar("id", 3, "string"),
        map_field("parameters", 4, "string", INFER_PARAMETER),
        message("outputs", 5, INFER_OUTPUT_TENSOR, repeated=True),
        scalar("raw_output_contents", 6, "bytes", repeated=True),
    ],
)

MODEL_STREAM_INFER_RESPONSE = MessageSpec(
    "ModelStreamInferResponse",
    [
        scalar("error_message", 1, "string"),
        message("infer_response", 2, MODEL_INFER_RESPONSE),
    ],
)

# ---------------------------------------------------------------------------
# health / metadata
# ---------------------------------------------------------------------------

EMPTY = MessageSpec("Empty", [])
SERVER_LIVE_RESPONSE = MessageSpec("ServerLiveResponse", [scalar("live", 1, "bool")])
SERVER_READY_RESPONSE = MessageSpec("ServerReadyResponse", [scalar("ready", 1, "bool")])
MODEL_READY_REQUEST = MessageSpec(
    "ModelReadyRequest", [scalar("name", 1, "string"), scalar("version", 2, "string")]
)
MODEL_READY_RESPONSE = MessageSpec("ModelReadyResponse", [scalar("ready", 1, "bool")])

SERVER_METADATA_RESPONSE = MessageSpec(
    "ServerMetadataResponse",
    [
        scalar("name", 1, "string"),
        scalar("version", 2, "string"),
        scalar("extensions", 3, "string", repeated=True),
    ],
)

MODEL_METADATA_REQUEST = MessageSpec(
    "ModelMetadataRequest", [scalar("name", 1, "string"), scalar("version", 2, "string")]
)

TENSOR_METADATA = MessageSpec(
    "TensorMetadata",
    [
        scalar("name", 1, "string"),
        scalar("datatype", 2, "string"),
        scalar("shape", 3, "int64", repeated=True),
    ],
)

MODEL_METADATA_RESPONSE = MessageSpec(
    "ModelMetadataResponse",
    [
        scalar("name", 1, "string"),
        scalar("versions", 2, "string", repeated=True),
        scalar("platform", 3, "string"),
        message("inputs", 4, TENSOR_METADATA, repeated=True),
        message("outputs", 5, TENSOR_METADATA, repeated=True),
    ],
)

# ---------------------------------------------------------------------------
# model config (commonly-consumed subset; unknown fields are skipped)
# ---------------------------------------------------------------------------

# DataType enum (model_config.proto): TYPE_INVALID=0, TYPE_BOOL=1, TYPE_UINT8=2,
# TYPE_UINT16=3, TYPE_UINT32=4, TYPE_UINT64=5, TYPE_INT8=6, TYPE_INT16=7,
# TYPE_INT32=8, TYPE_INT64=9, TYPE_FP16=10, TYPE_FP32=11, TYPE_FP64=12,
# TYPE_STRING=13, TYPE_BF16=14
CONFIG_DATATYPE_NAMES = [
    "TYPE_INVALID", "TYPE_BOOL", "TYPE_UINT8", "TYPE_UINT16", "TYPE_UINT32",
    "TYPE_UINT64", "TYPE_INT8", "TYPE_INT16", "TYPE_INT32", "TYPE_INT64",
    "TYPE_FP16", "TYPE_FP32", "TYPE_FP64", "TYPE_STRING", "TYPE_BF16",
]

MODEL_TENSOR_RESHAPE = MessageSpec(
    "ModelTensorReshape", [scalar("shape", 1, "int64", repeated=True)]
)

MODEL_INPUT = MessageSpec(
    "ModelInput",
    [
        scalar("name", 1, "string"),
        scalar("data_type", 2, "enum"),
        scalar("format", 3, "enum"),
        scalar("dims", 4, "int64", repeated=True),
        message("reshape", 5, MODEL_TENSOR_RESHAPE),
        scalar("is_shape_tensor", 6, "bool"),
        scalar("allow_ragged_batch", 7, "bool"),
        scalar("optional", 8, "bool"),
    ],
)

MODEL_OUTPUT = MessageSpec(
    "ModelOutput",
    [
        scalar("name", 1, "string"),
        scalar("data_type", 2, "enum"),
        scalar("dims", 3, "int64", repeated=True),
        scalar("label_filename", 4, "string"),
        message("reshape", 5, MODEL_TENSOR_RESHAPE),
        scalar("is_shape_tensor", 6, "bool"),
    ],
)

MODEL_TRANSACTION_POLICY = MessageSpec(
    "ModelTransactionPolicy", [scalar("decoupled", 1, "bool")]
)

MODEL_CONFIG = MessageSpec(
    "ModelConfig",
    [
        scalar("name", 1, "string"),
        scalar("platform", 2, "string"),
        scalar("max_batch_size", 4, "int32"),
        message("input", 5, MODEL_INPUT, repeated=True),
        message("output", 6, MODEL_OUTPUT, repeated=True),
        scalar("default_model_filename", 8, "string"),
        scalar("backend", 17, "string"),
        message("model_transaction_policy", 19, MODEL_TRANSACTION_POLICY),
        scalar("runtime", 25, "string"),
    ],
)

MODEL_CONFIG_REQUEST = MessageSpec(
    "ModelConfigRequest", [scalar("name", 1, "string"), scalar("version", 2, "string")]
)
MODEL_CONFIG_RESPONSE = MessageSpec(
    "ModelConfigResponse", [message("config", 1, MODEL_CONFIG)]
)

# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

STATISTIC_DURATION = MessageSpec(
    "StatisticDuration", [scalar("count", 1, "uint64"), scalar("ns", 2, "uint64")]
)

INFER_STATISTICS = MessageSpec(
    "InferStatistics",
    [
        message("success", 1, STATISTIC_DURATION),
        message("fail", 2, STATISTIC_DURATION),
        message("queue", 3, STATISTIC_DURATION),
        message("compute_input", 4, STATISTIC_DURATION),
        message("compute_infer", 5, STATISTIC_DURATION),
        message("compute_output", 6, STATISTIC_DURATION),
        message("cache_hit", 7, STATISTIC_DURATION),
        message("cache_miss", 8, STATISTIC_DURATION),
        # extension past the reference protocol: client-abandoned requests
        # (neither success nor fail; see server/core.py record_cancel)
        message("cancel", 9, STATISTIC_DURATION),
    ],
)

INFER_BATCH_STATISTICS = MessageSpec(
    "InferBatchStatistics",
    [
        scalar("batch_size", 1, "uint64"),
        message("compute_input", 2, STATISTIC_DURATION),
        message("compute_infer", 3, STATISTIC_DURATION),
        message("compute_output", 4, STATISTIC_DURATION),
    ],
)

MODEL_STATISTICS = MessageSpec(
    "ModelStatistics",
    [
        scalar("name", 1, "string"),
        scalar("version", 2, "string"),
        scalar("last_inference", 3, "uint64"),
        scalar("inference_count", 4, "uint64"),
        scalar("execution_count", 5, "uint64"),
        message("inference_stats", 6, INFER_STATISTICS),
        message("batch_stats", 7, INFER_BATCH_STATISTICS, repeated=True),
    ],
)

MODEL_STATISTICS_REQUEST = MessageSpec(
    "ModelStatisticsRequest", [scalar("name", 1, "string"), scalar("version", 2, "string")]
)
MODEL_STATISTICS_RESPONSE = MessageSpec(
    "ModelStatisticsResponse", [message("model_stats", 1, MODEL_STATISTICS, repeated=True)]
)

# ---------------------------------------------------------------------------
# repository control
# ---------------------------------------------------------------------------

MODEL_REPOSITORY_PARAMETER = MessageSpec(
    "ModelRepositoryParameter",
    [
        scalar("bool_param", 1, "bool", oneof="parameter_choice"),
        scalar("int64_param", 2, "int64", oneof="parameter_choice"),
        scalar("string_param", 3, "string", oneof="parameter_choice"),
        scalar("bytes_param", 4, "bytes", oneof="parameter_choice"),
    ],
)

REPOSITORY_INDEX_REQUEST = MessageSpec(
    "RepositoryIndexRequest",
    [scalar("repository_name", 1, "string"), scalar("ready", 2, "bool")],
)

MODEL_INDEX = MessageSpec(
    "RepositoryIndexResponse.ModelIndex",
    [
        scalar("name", 1, "string"),
        scalar("version", 2, "string"),
        scalar("state", 3, "string"),
        scalar("reason", 4, "string"),
    ],
)

REPOSITORY_INDEX_RESPONSE = MessageSpec(
    "RepositoryIndexResponse", [message("models", 1, MODEL_INDEX, repeated=True)]
)

REPOSITORY_MODEL_LOAD_REQUEST = MessageSpec(
    "RepositoryModelLoadRequest",
    [
        scalar("repository_name", 1, "string"),
        scalar("model_name", 2, "string"),
        map_field("parameters", 3, "string", MODEL_REPOSITORY_PARAMETER),
    ],
)

REPOSITORY_MODEL_UNLOAD_REQUEST = MessageSpec(
    "RepositoryModelUnloadRequest",
    [
        scalar("repository_name", 1, "string"),
        scalar("model_name", 2, "string"),
        map_field("parameters", 3, "string", MODEL_REPOSITORY_PARAMETER),
    ],
)

# ---------------------------------------------------------------------------
# shared memory (system / cuda-format / tpu)
# ---------------------------------------------------------------------------

SYSTEM_SHM_REGION_STATUS = MessageSpec(
    "SystemSharedMemoryStatusResponse.RegionStatus",
    [
        scalar("name", 1, "string"),
        scalar("key", 2, "string"),
        scalar("offset", 3, "uint64"),
        scalar("byte_size", 4, "uint64"),
    ],
)

SYSTEM_SHM_STATUS_REQUEST = MessageSpec(
    "SystemSharedMemoryStatusRequest", [scalar("name", 1, "string")]
)
SYSTEM_SHM_STATUS_RESPONSE = MessageSpec(
    "SystemSharedMemoryStatusResponse",
    [map_field("regions", 1, "string", SYSTEM_SHM_REGION_STATUS)],
)
SYSTEM_SHM_REGISTER_REQUEST = MessageSpec(
    "SystemSharedMemoryRegisterRequest",
    [
        scalar("name", 1, "string"),
        scalar("key", 2, "string"),
        scalar("offset", 3, "uint64"),
        scalar("byte_size", 4, "uint64"),
    ],
)
SYSTEM_SHM_UNREGISTER_REQUEST = MessageSpec(
    "SystemSharedMemoryUnregisterRequest", [scalar("name", 1, "string")]
)

DEVICE_SHM_REGION_STATUS = MessageSpec(
    "CudaSharedMemoryStatusResponse.RegionStatus",
    [
        scalar("name", 1, "string"),
        scalar("device_id", 2, "uint64"),
        scalar("byte_size", 3, "uint64"),
    ],
)

DEVICE_SHM_STATUS_REQUEST = MessageSpec(
    "CudaSharedMemoryStatusRequest", [scalar("name", 1, "string")]
)
DEVICE_SHM_STATUS_RESPONSE = MessageSpec(
    "CudaSharedMemoryStatusResponse",
    [map_field("regions", 1, "string", DEVICE_SHM_REGION_STATUS)],
)
DEVICE_SHM_REGISTER_REQUEST = MessageSpec(
    "CudaSharedMemoryRegisterRequest",
    [
        scalar("name", 1, "string"),
        scalar("raw_handle", 2, "bytes"),
        scalar("device_id", 3, "int64"),
        scalar("byte_size", 4, "uint64"),
    ],
)
DEVICE_SHM_UNREGISTER_REQUEST = MessageSpec(
    "CudaSharedMemoryUnregisterRequest", [scalar("name", 1, "string")]
)

# ---------------------------------------------------------------------------
# trace / log settings
# ---------------------------------------------------------------------------

TRACE_SETTING_VALUE = MessageSpec(
    "TraceSettingRequest.SettingValue", [scalar("value", 1, "string", repeated=True)]
)

TRACE_SETTING_REQUEST = MessageSpec(
    "TraceSettingRequest",
    [
        map_field("settings", 1, "string", TRACE_SETTING_VALUE),
        scalar("model_name", 2, "string"),
    ],
)
TRACE_SETTING_RESPONSE = MessageSpec(
    "TraceSettingResponse", [map_field("settings", 1, "string", TRACE_SETTING_VALUE)]
)

LOG_SETTING_VALUE = MessageSpec(
    "LogSettingsRequest.SettingValue",
    [
        scalar("bool_param", 1, "bool", oneof="parameter_choice"),
        scalar("uint32_param", 2, "uint32", oneof="parameter_choice"),
        scalar("string_param", 3, "string", oneof="parameter_choice"),
    ],
)

LOG_SETTINGS_REQUEST = MessageSpec(
    "LogSettingsRequest", [map_field("settings", 1, "string", LOG_SETTING_VALUE)]
)
LOG_SETTINGS_RESPONSE = MessageSpec(
    "LogSettingsResponse", [map_field("settings", 1, "string", LOG_SETTING_VALUE)]
)

# ---------------------------------------------------------------------------
# service method table: method name -> (request spec, response spec)
# ---------------------------------------------------------------------------

SERVICE = "inference.GRPCInferenceService"

METHODS = {
    "ServerLive": (EMPTY, SERVER_LIVE_RESPONSE),
    "ServerReady": (EMPTY, SERVER_READY_RESPONSE),
    "ModelReady": (MODEL_READY_REQUEST, MODEL_READY_RESPONSE),
    "ServerMetadata": (EMPTY, SERVER_METADATA_RESPONSE),
    "ModelMetadata": (MODEL_METADATA_REQUEST, MODEL_METADATA_RESPONSE),
    "ModelInfer": (MODEL_INFER_REQUEST, MODEL_INFER_RESPONSE),
    "ModelStreamInfer": (MODEL_INFER_REQUEST, MODEL_STREAM_INFER_RESPONSE),  # bidi
    "ModelConfig": (MODEL_CONFIG_REQUEST, MODEL_CONFIG_RESPONSE),
    "ModelStatistics": (MODEL_STATISTICS_REQUEST, MODEL_STATISTICS_RESPONSE),
    "RepositoryIndex": (REPOSITORY_INDEX_REQUEST, REPOSITORY_INDEX_RESPONSE),
    "RepositoryModelLoad": (REPOSITORY_MODEL_LOAD_REQUEST, EMPTY),
    "RepositoryModelUnload": (REPOSITORY_MODEL_UNLOAD_REQUEST, EMPTY),
    "SystemSharedMemoryStatus": (SYSTEM_SHM_STATUS_REQUEST, SYSTEM_SHM_STATUS_RESPONSE),
    "SystemSharedMemoryRegister": (SYSTEM_SHM_REGISTER_REQUEST, EMPTY),
    "SystemSharedMemoryUnregister": (SYSTEM_SHM_UNREGISTER_REQUEST, EMPTY),
    "CudaSharedMemoryStatus": (DEVICE_SHM_STATUS_REQUEST, DEVICE_SHM_STATUS_RESPONSE),
    "CudaSharedMemoryRegister": (DEVICE_SHM_REGISTER_REQUEST, EMPTY),
    "CudaSharedMemoryUnregister": (DEVICE_SHM_UNREGISTER_REQUEST, EMPTY),
    # TPU extension rpcs (the JAX package's server; absent on a stock triton
    # and UNIMPLEMENTED on the port's server)
    "TpuSharedMemoryStatus": (DEVICE_SHM_STATUS_REQUEST, DEVICE_SHM_STATUS_RESPONSE),
    "TpuSharedMemoryRegister": (DEVICE_SHM_REGISTER_REQUEST, EMPTY),
    "TpuSharedMemoryUnregister": (DEVICE_SHM_UNREGISTER_REQUEST, EMPTY),
    "TraceSetting": (TRACE_SETTING_REQUEST, TRACE_SETTING_RESPONSE),
    "LogSettings": (LOG_SETTINGS_REQUEST, LOG_SETTINGS_RESPONSE),
}


def method_path(method: str) -> str:
    return f"/{SERVICE}/{method}"
