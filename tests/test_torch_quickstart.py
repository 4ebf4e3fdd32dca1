"""The port's quickstart and product-search entry points on the CPU (every
kernel's plain version): all 13 quickstart steps with the reference's
checks, at the small size, and the product search's guarantee."""
from repro_torch.launch import product_search, quickstart


def test_quickstart_runs_all_steps_on_cpu(capsys):
    quickstart.main(["--device", "cpu", "--small"])
    out = capsys.readouterr().out
    assert "16 queries served, exact=True" in out
    for line in ("sharded round trip: 4 shards", "(scores vs brute force: equal)",
                 "reason='deadline'", "distributed trace: 3 pid lanes", "uploaded 1x"):
        assert line in out, line


def test_quickstart_summary_on_cpu():
    got = quickstart.run("cpu", small=True, log=lambda *_: None)
    assert got["device"] == "cpu" and got["arena_uploads"] == 1 and got["worker_lanes"] == 2
    assert 0.0 < got["gain"]["upper"] < 1.0 and got["gain"]["replaced"] > 0


def test_product_search_keeps_every_match_on_cpu(capsys):
    product_search.main(["--device", "cpu"])
    assert "guarantee holds: all 5 matching items present" in capsys.readouterr().out
