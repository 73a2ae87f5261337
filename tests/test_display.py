"""tev display-server protocol (reference util/display.h:23)."""
import socket
import struct
import threading

import numpy as np

from pbrt_jax.utils.display import DisplayServer


def _mock_tev(received):
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def run():
        conn, _ = srv.accept()
        buf = b""
        conn.settimeout(2.0)
        try:
            while True:
                data = conn.recv(65536)
                if not data:
                    break
                buf += data
                while len(buf) >= 4:
                    ln = struct.unpack("<I", buf[:4])[0]
                    if len(buf) < ln:
                        break
                    received.append(buf[4:ln])
                    buf = buf[ln:]
        except socket.timeout:
            pass
        conn.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return srv, srv.getsockname()[1], t


def test_display_packets():
    received = []
    srv, port, t = _mock_tev(received)
    d = DisplayServer("127.0.0.1", port)
    assert d.connected
    d.create_image("img", 4, 2)
    tile = np.arange(4 * 2 * 3, dtype=np.float32).reshape(2, 4, 3)
    d.update_image("img", tile)
    d.close_image("img")
    d.close()
    t.join(timeout=3)
    srv.close()
    assert len(received) == 5  # create + 3 channel updates + close
    assert received[0][0] == 4  # CreateImage
    # parse create: grabfocus, name, w, h, nchan
    p = received[0][1:]
    assert p[0] == 1
    assert p[1:5] == b"img\x00"
    w, h, nc = struct.unpack("<iii", p[5:17])
    assert (w, h, nc) == (4, 2, 3)
    # first update: channel R data matches
    u = received[1]
    assert u[0] == 3
    body = u[1:]
    assert body[1:5] == b"img\x00"
    assert body[5:7] == b"R\x00"
    x, y, tw, th = struct.unpack("<iiii", body[7:23])
    assert (x, y, tw, th) == (0, 0, 4, 2)
    vals = np.frombuffer(body[23:], np.float32)
    np.testing.assert_allclose(vals, tile[..., 0].ravel())
    assert received[4][0] == 2  # CloseImage


def test_display_noop_when_unreachable():
    d = DisplayServer("127.0.0.1", 1, timeout=0.2)  # nothing listens
    assert not d.connected
    d.create_image("x", 2, 2)   # must not raise
    d.update_image("x", np.zeros((2, 2, 3), np.float32))
