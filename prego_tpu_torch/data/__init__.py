from prego_tpu_torch.data.features import (
    CORRUPT_VIDEOS,
    FEATURE_SIZES,
    ZEROED_FLOW_TYPE,
    FeatureStore,
    load_feature_store,
)
from prego_tpu_torch.data.video_list import DatasetInfo, load_dataset_info, load_video_list
from prego_tpu_torch.data.native_loader import NativeRecognitionData, NativeWindowSampler
from prego_tpu_torch.data.windowing import (
    AnticipationWindowSampler,
    Batch,
    WindowSampler,
    pack_eval_batch,
)

__all__ = [
    "CORRUPT_VIDEOS",
    "FEATURE_SIZES",
    "ZEROED_FLOW_TYPE",
    "FeatureStore",
    "load_feature_store",
    "DatasetInfo",
    "load_dataset_info",
    "load_video_list",
    "NativeRecognitionData",
    "NativeWindowSampler",
    "AnticipationWindowSampler",
    "Batch",
    "WindowSampler",
    "pack_eval_batch",
]
