from .balancer import OCRBalancer, ServiceSupervisor
from .client import OCRIPCClient
from .executor import Dispatcher
from .service import OCRIPCService

__all__ = [
    "Dispatcher",
    "OCRBalancer",
    "OCRIPCClient",
    "OCRIPCService",
    "ServiceSupervisor",
]
