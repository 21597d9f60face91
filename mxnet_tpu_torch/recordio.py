"""RecordIO (counterpart of ``mxnet_tpu/recordio.py``, :27-296).

``MXRecordIO`` reads and writes length-prefixed records (magic
0xced7230a, the length's upper three bits a continuation flag, payloads
padded to 4 bytes), ``MXIndexedRecordIO`` seeks through an ``.idx``
sidecar, and ``IRHeader`` with ``pack``/``unpack``/``pack_img``/
``unpack_img`` frames an image record.  The bytes are the JAX package's
(and MXNet's), so a file written by either package reads in the other.
Bulk reads and writes go through the native library (``_native.py``,
``src/recordio.cc``) when it builds, else through Python.  Images decode
and encode through PIL when it imports, else as raw ``.npy`` payloads, as
the JAX package does (:266-296).
"""
from __future__ import annotations

import ctypes
import os
import struct
import numbers
from collections import namedtuple

import numpy as _np

_MAGIC = 0xced7230a


def _encode_lrec(cflag, length):
    return (cflag << 29) | length


def _decode_lrec(data):
    return (data >> 29) & 7, data & ((1 << 29) - 1)


class MXRecordIO:
    """Sequential RecordIO reader/writer (reference recordio.py MXRecordIO).

    Uses the native C++ fast path (src/recordio.cc via ctypes) when available;
    transparently falls back to pure Python."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self._native = None
        self._native_handle = None
        self.is_open = False
        self.open()

    def open(self):
        from . import _native
        self.pid = os.getpid()
        lib = _native.get_lib()
        if self.flag == "w":
            self.writable = True
            if lib is not None:
                h = lib.mxtpu_recio_writer_open(self.uri.encode())
                if h:
                    self._native, self._native_handle = lib, h
                    self.is_open = True
                    return
            self.handle = open(self.uri, "wb")
        elif self.flag == "r":
            self.writable = False
            if lib is not None and os.path.exists(self.uri):
                h = lib.mxtpu_recio_reader_open(self.uri.encode())
                if h:
                    self._native, self._native_handle = lib, h
                    self.is_open = True
                    return
            self.handle = open(self.uri, "rb")
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.is_open = True

    def close(self):
        if self.is_open:
            if self._native is not None and self._native_handle:
                if self.writable:
                    self._native.mxtpu_recio_writer_close(self._native_handle)
                else:
                    self._native.mxtpu_recio_reader_close(self._native_handle)
            elif self.handle:
                self.handle.close()
        self._native = None
        self._native_handle = None
        self.is_open = False

    def reset(self):
        self.close()
        self.open()

    def __del__(self):
        self.close()

    def __getstate__(self):
        is_open = self.is_open
        self.close()
        d = dict(self.__dict__)
        d["is_open"] = is_open
        d.pop("handle", None)
        d.pop("_native", None)
        d.pop("_native_handle", None)
        return d

    def __setstate__(self, d):
        self.__dict__ = d
        self.handle = None
        self._native = None
        self._native_handle = None
        if self.is_open:
            self.is_open = False
            self.open()

    def _check_pid(self):
        """A reader opened in another process (a forked DataLoader worker
        shares its parent's file offset) is reopened in this one, as
        MXNet's ``MXRecordIO._check_pid`` does; the JAX package reads
        through the shared offset."""
        if self.pid != os.getpid():
            if self.writable:
                raise IOError("%s was opened for writing in another "
                              "process" % self.uri)
            self.reset()

    def write(self, buf):
        """Write one record; returns its byte offset."""
        self._check_pid()
        if not self.writable:
            raise IOError("%s is open for reading" % self.uri)
        if self._native is not None:
            pos = self._native.mxtpu_recio_writer_write(
                self._native_handle, bytes(buf), len(buf))
            if pos < 0:
                raise IOError("native recordio write failed for %s" % self.uri)
            return pos
        pos = self.handle.tell()
        # single record, cflag 0
        self.handle.write(struct.pack("<II", _MAGIC, _encode_lrec(0, len(buf))))
        self.handle.write(buf)
        pad = (4 - len(buf) % 4) % 4
        if pad:
            self.handle.write(b"\x00" * pad)
        return pos

    def read(self):
        self._check_pid()
        if self.writable:
            raise IOError("%s is open for writing" % self.uri)
        if self._native is not None:
            data_ptr = ctypes.POINTER(ctypes.c_uint8)()
            n = self._native.mxtpu_recio_reader_next(self._native_handle,
                                                     ctypes.byref(data_ptr))
            if n == -1:
                return None
            if n < 0:
                raise IOError("corrupt RecordIO file %s" % self.uri)
            return ctypes.string_at(data_ptr, n)
        hdr = self.handle.read(8)
        if len(hdr) < 8:
            return None
        magic, lrec = struct.unpack("<II", hdr)
        if magic != _MAGIC:
            raise IOError("invalid RecordIO magic in %s" % self.uri)
        cflag, length = _decode_lrec(lrec)
        buf = self.handle.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self.handle.read(pad)
        if cflag in (0,):
            return buf
        # multi-part record (cflag 1=begin, 2=middle, 3=end)
        parts = [buf]
        while cflag not in (0, 3):
            hdr = self.handle.read(8)
            magic, lrec = struct.unpack("<II", hdr)
            cflag, length = _decode_lrec(lrec)
            part = self.handle.read(length)
            pad = (4 - length % 4) % 4
            if pad:
                self.handle.read(pad)
            parts.append(part)
        return b"".join(parts)

    def tell(self):
        if self._native is not None:
            if self.writable:
                return self._native.mxtpu_recio_writer_tell(self._native_handle)
            return self._native.mxtpu_recio_reader_tell(self._native_handle)
        return self.handle.tell()


class MXIndexedRecordIO(MXRecordIO):
    """Random-access RecordIO with .idx sidecar (reference MXIndexedRecordIO)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == "r" and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    if len(parts) < 2:
                        continue
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)

    def close(self):
        if self.is_open and self.flag == "w":
            with open(self.idx_path, "w") as fout:
                for k in self.keys:
                    fout.write("%s\t%d\n" % (str(k), self.idx[k]))
        super().close()

    def seek(self, idx):
        self._check_pid()
        if self.writable:
            raise IOError("%s is open for writing" % self.uri)
        if self._native is not None:
            self._native.mxtpu_recio_reader_seek(self._native_handle,
                                                 self.idx[idx])
        else:
            self.handle.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.write(buf)
        self.keys.append(key)
        self.idx[key] = pos


IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack a header and byte payload into one record string."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        header = header._replace(flag=0)
    else:
        label = _np.asarray(header.label, dtype=_np.float32)
        header = header._replace(flag=label.size, label=0)
        s = label.tobytes() + s
    s = struct.pack(_IR_FORMAT, *header) + s
    return s


def unpack(s):
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = _np.frombuffer(s[:header.flag * 4], dtype=_np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def unpack_img(s, iscolor=1):
    header, s = unpack(s)
    img = _decode_jpeg(s, iscolor)
    return header, img


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    buf = _encode_img(img, quality=quality, img_fmt=img_fmt)
    return pack(header, buf)


def _decode_jpeg(buf, iscolor=1):
    """Decode an image buffer to HWC uint8 numpy (no OpenCV in image: PIL or
    pure-numpy fallbacks)."""
    try:
        from PIL import Image
        import io as _io
        img = Image.open(_io.BytesIO(buf))
        img = img.convert("RGB" if iscolor else "L")
        return _np.asarray(img)
    except ImportError:
        # raw fallback: assume payload is a raw npy buffer
        try:
            import io as _io
            return _np.load(_io.BytesIO(buf), allow_pickle=False)
        except Exception as e:
            raise RuntimeError("no image decoder available (install PIL) "
                               "or pack raw .npy payloads") from e


def _encode_img(img, quality=95, img_fmt=".jpg"):
    try:
        from PIL import Image
        import io as _io
        buf = _io.BytesIO()
        Image.fromarray(_np.asarray(img).astype(_np.uint8)).save(
            buf, format="JPEG" if img_fmt in (".jpg", ".jpeg") else "PNG",
            quality=quality)
        return buf.getvalue()
    except ImportError:
        import io as _io
        buf = _io.BytesIO()
        _np.save(buf, _np.asarray(img))
        return buf.getvalue()
