"""AppSuite: per-service RED metrics (Rate, Errors, Duration) on the device.

One batched update per l7 batch advances, for every hashed service group
at once, the request counts and the error counts (each one launch of the
hist kernel into a `groups`-bin row) and a latency DDSketch
(`ops/ddsketch`, one launch into its flat `groups*buckets` row). `flush`
returns per-group request and error counts and the configured quantiles
with bounded relative error. Everything merges by add.

The state is int32 counts, added into in place (the reference's is
float32, rebuilt each batch); `flush` reads it out as the reference's
float32 window output. The u32 columns arrive as int32 bits and are read
as u32 before any comparison: a status of 2^31 or more is an error, an
rrt_us of 2^31 or more lands in the top buckets.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import torch

from deepflow_tpu_torch.models.flow_suite import check_device
from deepflow_tpu_torch.ops import ddsketch, mxu_hist
from deepflow_tpu_torch.utils.u32 import as_u32, fold_columns


@dataclass(frozen=True)
class AppSuiteConfig:
    groups: int = 1024            # hashed service space
    dd_buckets: int = 512         # see DDSketchConfig: range = g^buckets
    dd_alpha: float = 0.02
    quantiles: Tuple[float, ...] = (0.5, 0.95, 0.99)

    @property
    def dd(self) -> ddsketch.DDSketchConfig:
        return ddsketch.DDSketchConfig(groups=self.groups,
                                       buckets=self.dd_buckets,
                                       alpha=self.dd_alpha)


class AppSuiteState(NamedTuple):
    requests: torch.Tensor        # [groups] int32
    errors: torch.Tensor          # [groups] int32
    rrt: ddsketch.DDSketchState


class AppWindowOutput(NamedTuple):
    requests: torch.Tensor        # [groups] float32
    errors: torch.Tensor          # [groups] float32 (counts: ratios do not
    #                               add across windows)
    error_ratio: torch.Tensor     # [groups] float32 in [0, 1]
    rrt_quantiles: torch.Tensor   # [len(quantiles), groups] float32 (us)
    rrt_hist: torch.Tensor        # [groups, buckets] float32
    rrt_zeros: torch.Tensor       # [groups] float32 (values < min_value)


def init(cfg: AppSuiteConfig, device="cuda") -> AppSuiteState:
    device = check_device(device)
    return AppSuiteState(
        requests=torch.zeros(cfg.groups, dtype=torch.int32, device=device),
        errors=torch.zeros(cfg.groups, dtype=torch.int32, device=device),
        rrt=ddsketch.init(cfg.dd, device))


def service_group(cols: Dict[str, torch.Tensor], groups: int) -> torch.Tensor:
    """[n] int32 hashed service id from the l7 row's server side, the
    (ip, port, protocol) key space of flow_suite's service key; `proto`
    stands in for a missing `protocol`."""
    key = fold_columns([cols["ip_dst"], cols["port_dst"],
                        cols.get("protocol", cols.get("proto"))])
    return (key % groups).to(torch.int32)


def update(state: AppSuiteState, cols: Dict[str, torch.Tensor],
           mask: torch.Tensor, cfg: AppSuiteConfig) -> AppSuiteState:
    """One l7 batch into `state` in place (returned): needs ip_dst,
    port_dst, protocol (the service key), status and rrt_us columns,
    integers read as u32, and a [n] bool mask of the valid rows."""
    group = service_group(cols, cfg.groups)
    status = as_u32(cols["status"])
    # protocol-native codes: HTTP parsers store the response code, the
    # enum-style parsers 0 for ok and small non-zero error codes. Error =
    # HTTP 4xx/5xx or a non-zero code below 100; HTTP 1xx-3xx are not.
    is_err = (status >= 400) | ((status > 0) & (status < 100))
    idx = group[None, :]
    mxu_hist.hist_add_(state.requests.view(1, -1), idx, cfg.groups, None,
                       mask)
    mxu_hist.hist_add_(state.errors.view(1, -1), idx, cfg.groups, None,
                       mask & is_err)
    ddsketch.update(state.rrt, group, cols["rrt_us"], mask=mask, cfg=cfg.dd)
    return state


def merge(a: AppSuiteState, b: AppSuiteState) -> AppSuiteState:
    """Exact union (every field adds), into new tensors."""
    return AppSuiteState(requests=a.requests + b.requests,
                         errors=a.errors + b.errors,
                         rrt=ddsketch.merge(a.rrt, b.rrt))


def flush(state: AppSuiteState, cfg: AppSuiteConfig
          ) -> Tuple[AppSuiteState, AppWindowOutput]:
    """The window's readout, and a fresh state on the same device."""
    requests = state.requests.to(torch.float32)
    errors = state.errors.to(torch.float32)
    out = AppWindowOutput(
        requests=requests,
        errors=errors,
        error_ratio=errors / torch.clamp(requests, min=1.0),
        rrt_quantiles=ddsketch.quantiles(state.rrt, cfg.quantiles, cfg.dd),
        rrt_hist=state.rrt.hist.to(torch.float32),
        rrt_zeros=state.rrt.zeros.to(torch.float32))
    return init(cfg, state.requests.device), out
