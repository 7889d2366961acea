"""The port's browser viewer (``foveax_torch/web/``), served by the port's
``--http-port`` server: the same static files as foveax's viewer."""

import urllib.request
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = ["viewer.html", "unwarp.js", "selftest.html", "selftest_golden.js"]


def test_http_port_serves_viewer():
    from foveax_torch.cli.main import _start_web_server

    httpd = _start_web_server(0, 9562)
    try:
        port = httpd.server_address[1]
        html = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/viewer.html", timeout=10
        ).read()
        js = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/unwarp.js", timeout=10
        ).read()
        assert b"foveax" in html and b"axisVectors" in js
        assert html == (ROOT / "foveax_torch" / "web" / "viewer.html").read_bytes()
    finally:
        httpd.shutdown()


@pytest.mark.parametrize("name", FILES)
def test_web_files_equal_foveax(name):
    """Each file of the port's viewer is byte-equal to foveax's (whose
    self-test vectors ``test_web.py`` keeps up to date), and the port
    ships no other."""
    got = ROOT / "foveax_torch" / "web" / name
    assert got.read_bytes() == (ROOT / "foveax" / "web" / name).read_bytes()
    assert sorted(p.name for p in got.parent.iterdir()) == sorted(FILES)
