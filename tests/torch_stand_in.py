"""A tensor on a device no kernel wrapper of the port serves, for the
tests that show a wrapper raises there instead of running its plain
version: it reports its shape, dtype and device, holds no storage, and
any operation on it fails, so a wrapper must refuse it before touching
it. (`meta` is served: the dry run's count.)"""
import torch


class OtherDevice(torch.Tensor):
    @staticmethod
    def __new__(cls, *shape, dtype=torch.float32):
        return torch.Tensor._make_wrapper_subclass(
            cls, shape, dtype=dtype, device=torch.device("xpu"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} ran on a stand-in tensor")
