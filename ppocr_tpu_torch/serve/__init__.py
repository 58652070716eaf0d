from .client import OCRIPCClient
from .executor import Dispatcher
from .service import OCRIPCService

__all__ = ["Dispatcher", "OCRIPCClient", "OCRIPCService"]
