from abcsmc_tpu_torch.storage.base import GenerationData, Storage
from abcsmc_tpu_torch.storage.memstore import MemoryStorage
from abcsmc_tpu_torch.storage.sqlite_store import SQLiteStorage

__all__ = ["GenerationData", "Storage", "MemoryStorage", "SQLiteStorage"]
