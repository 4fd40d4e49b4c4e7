from prego_tpu_torch.native.store import NativeFeatureStore, build_library, library_path

__all__ = ["NativeFeatureStore", "build_library", "library_path"]
