"""The cassandra and memcached parsers in both packages.

The port's ``l7`` package registers the reference's production parsers
as the reference's does, so ``ProxyManager``'s parser instance takes a
cassandra or memcached connection in both.  The cases of
``tests/test_l7_parsers.py`` run on each package (``pkg``), and the
port's ops must equal the reference's on the same frames.
"""

import struct
from types import SimpleNamespace

import pytest

import cilium_tpu.l7.cassandra as ref_cassandra
import cilium_tpu.l7.memcached as ref_memcached
import cilium_tpu.l7.parser as ref_parser
from cilium_tpu.proxy import ProxyManager as RefProxyManager

import cilium_tpu_torch.l7.cassandra as cassandra
import cilium_tpu_torch.l7.memcached as memcached
import cilium_tpu_torch.l7.parser as parser
from cilium_tpu_torch.proxy import ProxyManager

REF = SimpleNamespace(cassandra=ref_cassandra, memcached=ref_memcached,
                      parser=ref_parser, ProxyManager=RefProxyManager,
                      kw={})
PORT = SimpleNamespace(cassandra=cassandra, memcached=memcached,
                       parser=parser, ProxyManager=ProxyManager,
                       kw={"device": "cpu"})


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return REF if request.param == "ref" else PORT


def rules(pkg, *dicts):
    return [pkg.parser.PortRuleL7.from_dict(d) for d in dicts]


def ops(result):
    return [(o.op, o.n, o.data) for o in result]


def cql_frame(query: str, opcode=0x07, stream=1, version=0x04) -> bytes:
    q = query.encode()
    body = struct.pack(">i", len(q)) + q
    return struct.pack(">BBhBi", version, 0, stream, opcode,
                       len(body)) + body


def bin_get(key: bytes) -> bytes:
    return struct.pack(">BBHBBHIIQ", 0x80, 0x00, len(key), 0, 0, 0,
                       len(key), 7, 0) + key


# ---------------------------------------------------------- registration

def test_registries_are_equal():
    assert parser.REGISTRY.protocols() == ref_parser.REGISTRY.protocols() \
        == ["block", "cassandra", "line", "memcache", "memcached"]


@pytest.mark.parametrize("proto", ["cassandra", "memcache", "memcached"])
def test_proxy_manager_takes_the_connection(pkg, proto):
    """The agent's parser instance parses what the reference parses;
    before the parsers were registered the port refused these."""
    inst = pkg.ProxyManager(**pkg.kw).parser_instance
    assert inst.on_new_connection(proto, 7, True, 300, 400)


# ------------------------------------------------------------- cassandra

def test_parse_query_actions_and_tables(pkg):
    pq = pkg.cassandra.parse_query
    assert pq("SELECT * FROM ks.users WHERE id=1") == ("select", "ks.users")
    assert pq("insert into ks.orders (a) values (1)") == \
        ("insert", "ks.orders")
    assert pq("UPDATE ks.users SET a=1") == ("update", "ks.users")
    assert pq("DELETE FROM ks.t WHERE x=1") == ("delete", "ks.t")
    assert pq("USE myks") == ("use", "myks")
    assert pq("TRUNCATE ks.t") == ("truncate", "ks.t")
    assert pq("garbage text") == ("", "")


def _cass(pkg, *dicts):
    inst = pkg.parser.Instance()
    assert inst.on_new_connection("cassandra", 1, True, 300, 400,
                                  l7_rules=rules(pkg, *dicts))
    return inst


def test_cassandra_acl_allow_deny_and_inject(pkg):
    Op = pkg.parser.Op
    inst = _cass(pkg, {"query_action": "select",
                       "query_table": "ks.public*"})
    ok = inst.on_data(1, False, False,
                      cql_frame("SELECT * FROM ks.public_posts"))
    assert [o.op for o in ok] == [Op.PASS]
    denied = inst.on_data(1, False, False,
                          cql_frame("SELECT * FROM ks.secrets"))
    assert [o.op for o in denied] == [Op.DROP, Op.INJECT]
    frame = denied[1].data
    ver, _f, _stream, opcode, _length = struct.unpack(">BBhBi", frame[:9])
    assert ver & 0x80 and opcode == 0x00
    (code,) = struct.unpack(">i", frame[9:13])
    assert code == pkg.cassandra.UNAUTHORIZED_CODE
    denied2 = inst.on_data(1, False, False, cql_frame(
        "INSERT INTO ks.public_x (a) VALUES (1)"))
    assert denied2[0].op == Op.DROP


def test_cassandra_chunked_frames_and_replies(pkg):
    Op = pkg.parser.Op
    inst = _cass(pkg, {"query_action": "select", "query_table": "ks.t"})
    frame = cql_frame("SELECT * FROM ks.t")
    got = inst.on_data(1, False, False, frame[:4])
    assert got[0].op == Op.MORE and got[0].n == 5
    assert inst.on_data(1, False, False, frame[:12])[0].op == Op.MORE
    got = inst.on_data(1, False, False, frame + frame)
    assert [o.op for o in got] == [Op.PASS, Op.PASS]
    assert got[0].n == len(frame)
    assert [o.op for o in inst.on_data(1, True, False, frame)] == [Op.PASS]
    startup = struct.pack(">BBhBi", 4, 0, 0, 0x01, 0)
    assert inst.on_data(1, False, False, startup)[0].op == Op.PASS


def test_cassandra_batch_frames_enforced(pkg):
    Op = pkg.parser.Op

    def batch_frame(queries, stream=1):
        body = bytes([0]) + struct.pack(">H", len(queries))
        for q in queries:
            qb = q.encode()
            body += bytes([0]) + struct.pack(">i", len(qb)) + qb
            body += struct.pack(">H", 0)
        return struct.pack(">BBhBi", 4, 0, stream, pkg.cassandra.OP_BATCH,
                           len(body)) + body

    inst = _cass(pkg, {"query_action": "insert", "query_table": "ks.audit"})
    ok = inst.on_data(1, False, False, batch_frame(
        ["INSERT INTO ks.audit (a) VALUES (1)",
         "INSERT INTO ks.audit (a) VALUES (2)"]))
    assert [o.op for o in ok] == [Op.PASS]
    denied = inst.on_data(1, False, False, batch_frame(
        ["INSERT INTO ks.audit (a) VALUES (1)",
         "SELECT * FROM ks.secrets"]))
    assert [o.op for o in denied] == [Op.DROP, Op.INJECT]
    garbage = struct.pack(">BBhBi", 4, 0, 1, pkg.cassandra.OP_BATCH, 3) + \
        b"\xff\xff\xff"
    assert inst.on_data(1, False, False, garbage)[0].op == Op.DROP


# -------------------------------------------------------------- memcached

def _mc(pkg, *dicts, conn_id=2):
    inst = pkg.parser.Instance()
    assert inst.on_new_connection("memcache", conn_id, True, 300, 400,
                                  l7_rules=rules(pkg, *dicts))
    return inst, conn_id


def test_memcached_text_get_set_acl(pkg):
    Op = pkg.parser.Op
    inst, cid = _mc(pkg, {"command": "get", "key": "sess:*"},
                    {"command": "set", "key": "sess:*"})
    assert [o.op for o in inst.on_data(cid, False, False,
                                       b"get sess:42\r\n")] == [Op.PASS]
    got = inst.on_data(cid, False, False, b"get sess:1 other:2\r\n")
    assert got[0].op == Op.DROP and \
        got[1].data == pkg.memcached.DENY_TEXT
    payload = b"set sess:9 0 60 5\r\nhello\r\n"
    got = inst.on_data(cid, False, False, payload)
    assert [o.op for o in got] == [Op.PASS] and got[0].n == len(payload)
    assert inst.on_data(cid, False, False,
                        b"set other 0 60 2\r\nhi\r\n")[0].op == Op.DROP
    assert inst.on_data(cid, False, False,
                        b"delete sess:42\r\n")[0].op == Op.DROP
    inst2, cid2 = _mc(pkg, {"command": "version"}, conn_id=3)
    assert inst2.on_data(cid2, False, False,
                         b"version\r\n")[0].op == Op.PASS
    assert inst2.on_data(cid2, False, False, b"stats\r\n")[0].op == Op.DROP


def test_memcached_partial_frames(pkg):
    Op = pkg.parser.Op
    inst, cid = _mc(pkg)
    assert inst.on_data(cid, False, False, b"get ses")[0].op == Op.MORE
    got = inst.on_data(cid, False, False, b"set k 0 0 10\r\nabc")
    assert got[0].op == Op.MORE
    assert got[0].n == len(b"set k 0 0 10\r\n") + 12 - len(
        b"set k 0 0 10\r\nabc")
    assert inst.on_data(cid, True, False, b"VALUE k 0 1\r\nx\r\nEND\r\n"
                        )[0].op == Op.PASS


def test_memcached_binary_protocol(pkg):
    Op = pkg.parser.Op
    inst, cid = _mc(pkg, {"command": "get", "key": "ok*"})
    assert [o.op for o in inst.on_data(cid, False, False,
                                       bin_get(b"ok:1"))] == [Op.PASS]
    got = inst.on_data(cid, False, False, bin_get(b"secret"))
    assert got[0].op == Op.DROP and got[1].op == Op.INJECT
    magic, _op, _kl, _el, _dt, status = struct.unpack(">BBHBBH",
                                                      got[1].data[:8])
    assert magic == 0x81 and status == 0x08
    got = inst.on_data(cid, False, False, bin_get(b"ok:1")[:10])
    assert got[0].op == Op.MORE and got[0].n == 14
    assert pkg.parser.Instance().on_new_connection("memcached", 9, True,
                                                   1, 2)


def test_memcached_rejects_hostile_bytes_field(pkg):
    Op = pkg.parser.Op
    inst, cid = _mc(pkg, conn_id=5)
    assert inst.on_data(cid, False, False,
                        b"set x 0 0 -16\r\nget y\r\n")[0].op == Op.ERROR
    assert inst.on_data(cid, False, False,
                        b"set k 0 0 4294967295\r\n")[0].op == Op.ERROR


# ----------------------------------------------------- across packages

def test_ops_equal_across_packages():
    """One stream of frames through both packages' parsers: the same
    ops, byte counts and injected replies."""
    frames = [cql_frame("SELECT * FROM ks.public_a"),
              cql_frame("SELECT * FROM ks.secret"),
              cql_frame("SELECT * FROM ks.public_b")[:7],
              cql_frame("DELETE FROM ks.public_a WHERE x=1")]
    mc = [b"get sess:1\r\n", b"get nope\r\n", b"set sess:2 0 0 3\r\nabc\r\n",
          bin_get(b"sess:3"), bin_get(b"other"), b"set k 0 0 -1\r\n"]
    seen = []
    for p in (REF, PORT):
        inst = _cass(p, {"query_action": "select",
                         "query_table": "ks.public*"})
        got = [ops(inst.on_data(1, False, False, f)) for f in frames]
        inst, cid = _mc(p, {"command": "get", "key": "sess:*"},
                        {"command": "set", "key": "sess:*"})
        got += [ops(inst.on_data(cid, False, False, f)) for f in mc]
        seen.append([[(op.value, n, data) for op, n, data in g]
                     for g in got])
    assert seen[0] == seen[1]
