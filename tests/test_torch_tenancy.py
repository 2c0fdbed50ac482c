"""``client_tpu_torch.tenancy`` against ``client_tpu.tenancy``.

- ``parse_tenancy_spec``: the same spec strings give the same tenant
  contracts, and the same malformed strings raise the same errors;
- ``TenancyPolicy``: one seeded script of quota takes, charges, admits,
  sheds, results and clock steps under an injected clock gives the same
  ``try_take`` verdicts (with ``retry_after_s``), the same ``snapshot`` and
  the same ``noisy_neighbors`` in both packages;
- the pool's admission gate over stub endpoints: an ``AdmissionController``
  built from a spec string sheds a metered tenant's excess as typed
  ``over_quota`` with the same ``retry_after_s`` in both packages, and
  never sheds the unmetered tenant; ``tenant=`` never reaches a frontend.
"""

import numpy as np
import pytest

import client_tpu.admission as jax_adm
import client_tpu.pool as jax_pool
import client_tpu.tenancy as jax_ten
import client_tpu_torch.admission as port_adm
import client_tpu_torch.pool as port_pool
import client_tpu_torch.tenancy as port_ten
from client_tpu._base import InferenceServerClientBase as JaxBase
from client_tpu_torch._base import InferenceServerClientBase as PortBase
from test_torch_flight import _time_limit  # noqa: F401 (autouse: a time limit a test)

PKG = {"port": {"ten": port_ten, "adm": port_adm, "pool": port_pool, "base": PortBase},
       "jax": {"ten": jax_ten, "adm": jax_adm, "pool": jax_pool, "base": JaxBase}}
SPECS = [
    "alpha,rate=50,weight=2;beta,rate=50;adv,rate=50,slo_ms=250",
    "a,r=5,b=5;b,w=3",
    "solo",
    "t0,rate=2.5,burst=1,slo_objective=0.9,cache_bytes=4096;t1,weight=0.5",
]
BAD_SPECS = ["", ";", ",rate=1", "a,rate", "a,color=red", "a,rate=x", "a,weight=-1",
             "a,rate=0"]


class FakeClock:
    def __init__(self, t=50.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.mark.parametrize("spec", SPECS)
def test_parse_tenancy_spec_matches_jax(spec):
    port = port_ten.parse_tenancy_spec(spec, clock=FakeClock())
    ref = jax_ten.parse_tenancy_spec(spec, clock=FakeClock())
    assert port.tenants() == ref.tenants()
    assert [port.spec(t).to_obj() for t in port.tenants()] == \
        [ref.spec(t).to_obj() for t in ref.tenants()]
    assert port.snapshot() == ref.snapshot()


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type and text are compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_raise_as_jax(spec):
    port = _error(lambda: port_ten.parse_tenancy_spec(spec))
    assert port is not None
    assert port == _error(lambda: jax_ten.parse_tenancy_spec(spec))


def _run_policy(pkg, spec, seed):
    ten = PKG[pkg]["ten"]
    clock = FakeClock()
    policy = ten.parse_tenancy_spec(spec, clock=clock, window_s=10.0)
    names = policy.tenants() + [None, "late"]
    rng = np.random.default_rng(seed)
    log = []
    for _ in range(400):
        r = rng.random()
        tenant = names[int(rng.integers(len(names)))]
        if r < 0.5:
            ok, retry = policy.try_take(tenant)
            log.append(("take", ok, retry))
            if ok:
                policy.on_admit(tenant)
            else:
                policy.on_shed(tenant, "over_quota")
        elif r < 0.75:
            policy.on_result(tenant, float(rng.uniform(0.0, 0.5)), bool(rng.random() < 0.9))
        elif r < 0.8:
            policy.charge(tenant)
        else:
            clock.t += float(rng.uniform(0.0, 0.05))
        if rng.random() < 0.05:
            log.append(("noisy", policy.noisy_neighbors()))
    return log, policy.snapshot()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("spec", SPECS)
def test_policy_verdicts_match_jax(spec, seed):
    port = _run_policy("port", spec, seed)
    assert port == _run_policy("jax", spec, seed)
    takes = [entry for entry in port[0] if entry[0] == "take"]
    if spec.startswith(("a,r=5", "t0,rate=2.5")):
        # a low quota runs dry: refused with an honest, positive retry hint
        assert any(not ok and retry > 0 for _, ok, retry in takes)


def _stub_factory(base, seen):
    class Stub(base):
        _FRONTEND = "stub"

        def __init__(self, url):
            super().__init__()
            self.url = url

        def infer(self, model_name, inputs=None, **kwargs):
            seen.append(dict(kwargs))
            return {"url": self.url}

        def is_server_ready(self, probe=False, client_timeout=None, **kw):
            return True

        def close(self):
            pass

    return Stub


def _drive_tenants(pkg):
    mods = PKG[pkg]
    clock = FakeClock()
    seen = []
    controller = mods["adm"].AdmissionController(
        tenancy="steady,weight=3;burst,rate=5,burst=5", clock=clock)
    pool = mods["pool"].PoolClient(["a:1", "b:2"], client_factory=_stub_factory(
        mods["base"], seen), admission=controller, health_interval_s=30.0)
    verdicts = []
    try:
        for i in range(40):
            for tenant in ("burst", "steady"):
                try:
                    pool.infer("m", [], tenant=tenant)
                    verdicts.append((tenant, "ok", None))
                except mods["adm"].AdmissionRejected as e:
                    verdicts.append((tenant, e.reason, e.retry_after_s))
            clock.t += 1.0 / 40
        snap = controller.tenancy.snapshot()
    finally:
        pool.close()
    return verdicts, snap, seen


def test_pool_admission_sheds_the_metered_tenant_as_jax():
    port = _drive_tenants("port")
    ref = _drive_tenants("jax")
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    burst = [v for v in port[0] if v[0] == "burst"]
    shed = [v for v in burst if v[1] != "ok"]
    assert len(shed) >= 30
    assert all(v[1] == "over_quota" and v[2] > 0 for v in shed)
    assert all(v[1] == "ok" for v in port[0] if v[0] == "steady")
    # the gate consumes tenant=: no frontend call carries it
    assert port[2] and all("tenant" not in kw for kw in port[2])
