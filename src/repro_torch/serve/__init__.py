from repro_torch.serve.engine import (BlockAllocator, Request, Result,
                                      ServeEngine)

__all__ = ["BlockAllocator", "Request", "Result", "ServeEngine"]
