"""PyTorch port: JPEG decoding and writing in the host library against cv2,
and the import guard of the port.

Every comparison here is exact (tolerance 0 levels):

- decode: seeded images encoded by ``cv2.imencode`` at qualities 50/90/95,
  chroma 4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1, gray files, odd sizes down
  to 1x1, restart intervals, read by ``imageio.imread`` with the color,
  grayscale (a YCbCr file's luma plane) and unchanged flags against
  ``cv2.imread``, and by ``imageio.imread_pil`` against PIL;
- RGB-coded files (no JFIF; component ids 'R', 'G', 'B', or Adobe
  transform 0);
- EXIF orientations 0-9 in both TIFF byte orders: ``'color'`` and
  ``'grayscale'`` turn the image as cv2 does (5-8 swap height and width),
  ``'unchanged'`` does not;
- the numpy reference of the pixel stages (islow IDCT, fancy upsampling,
  jdcolor.c tables) on the library's coefficients equals the library;
- the writer: files of ``imageio.imwrite`` (4:2:0, 4:4:4, gray, with an
  EXIF tag) decode identically in cv2 and in the port, with a mean error
  within 10% (+0.5 level) of cv2's own encoder's at the same quality;
- progressive, 12-bit and CMYK files raise ``ValueError`` naming the file
  and the feature; no other decoder is tried.
"""
import ast
import glob
import os
import os.path as osp
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from lednet_tpu_torch import native
from lednet_tpu_torch.datasets import imageio
from lednet_tpu_torch.native import reference
from test_torch_port_common import REPO

SAMPLING = {s: getattr(cv2, f'IMWRITE_JPEG_SAMPLING_FACTOR_{s}')
            for s in ('444', '422', '420', '440', '411')}
FLAGS = (('color', cv2.IMREAD_COLOR), ('grayscale', cv2.IMREAD_GRAYSCALE),
         ('unchanged', cv2.IMREAD_UNCHANGED))
SIZES = ((1, 1), (2, 3), (7, 9), (16, 15), (17, 33), (37, 53), (64, 3))


def _photo(rng, h, w, channels=3):
    """Smooth content with noise: what a camera gives, and every
    coefficient band busy."""
    shape = (h, w, channels) if channels > 1 else (h, w)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    if min(h, w) >= 5:
        img = cv2.GaussianBlur(img, (5, 5), 1.0)
        img = np.clip(img + rng.normal(0, 6, shape), 0, 255).astype(np.uint8)
    return img


def _write(path, data):
    with open(path, 'wb') as f:
        f.write(data)
    return path


def _assert_reads_like_cv2(path):
    for flag, cv_flag in FLAGS:
        want = cv2.imread(path, cv_flag)
        got = imageio.imread(path, flag)
        assert got.shape == want.shape and got.dtype == np.uint8, (flag, got.shape)
        np.testing.assert_array_equal(got, want, err_msg=flag)


@pytest.mark.parametrize('quality', [50, 90, 95])
@pytest.mark.parametrize('sampling', sorted(SAMPLING))
def test_decode_equals_cv2(tmp_path, quality, sampling):
    rng = np.random.default_rng(quality)
    for h, w in SIZES + ((120, 201),):
        ok, buf = cv2.imencode('.jpg', _photo(rng, h, w), [
            cv2.IMWRITE_JPEG_QUALITY, quality,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
        assert ok
        _assert_reads_like_cv2(_write(str(tmp_path / f'{h}x{w}.jpg'), buf.tobytes()))
    path = str(tmp_path / '120x201.jpg')
    with Image.open(path) as im:
        np.testing.assert_array_equal(imageio.imread_pil(path), np.array(im))


@pytest.mark.parametrize('restart', [0, 1, 3, 50])
def test_gray_files_and_restart_intervals_equal_cv2(tmp_path, restart):
    rng = np.random.default_rng(restart)
    for h, w in SIZES:
        for channels in (1, 3):
            ok, buf = cv2.imencode('.jpg', _photo(rng, h, w, channels), [
                cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
            assert (b'\xff\xdd' in buf.tobytes()) == (restart > 0)
            _assert_reads_like_cv2(_write(str(tmp_path / f'{h}x{w}x{channels}.jpg'),
                                          buf.tobytes()))


def _exif_segment(orientation, little_endian):
    e = '<' if little_endian else '>'
    tiff = (b'II' if little_endian else b'MM') + struct.pack(e + 'HI', 42, 8)
    tiff += struct.pack(e + 'H', 2)
    tiff += struct.pack(e + 'HHI', 0x010F, 2, 4) + b'cam\0'     # Make, inline
    tiff += struct.pack(e + 'HHIH', 0x0112, 3, 1, orientation) + b'\0\0'
    tiff += struct.pack(e + 'I', 0)
    body = b'Exif\0\0' + tiff
    return b'\xff\xe1' + struct.pack('>H', len(body) + 2) + body


@pytest.mark.parametrize('little_endian', [True, False])
def test_exif_orientation_like_cv2(tmp_path, little_endian):
    rng = np.random.default_rng(4)
    ok, buf = cv2.imencode('.jpg', _photo(rng, 40, 60))
    data = buf.tobytes()
    for orientation in range(10):
        path = _write(str(tmp_path / f'o{orientation}.jpg'),
                      data[:2] + _exif_segment(orientation, little_endian) + data[2:])
        _assert_reads_like_cv2(path)
        turned = orientation in (5, 6, 7, 8)
        assert imageio.imread(path).shape == ((60, 40, 3) if turned else (40, 60, 3))
        assert imageio.imread(path, 'unchanged').shape == (40, 60, 3)
        assert native.jpeg_header(open(path, 'rb').read())['orientation'] == orientation


def _segments(data):
    """(marker, body) of each segment up to and including SOS, then the rest."""
    out, pos = [], 2
    while True:
        marker, length = data[pos + 1], struct.unpack('>H', data[pos + 2:pos + 4])[0]
        out.append((marker, data[pos + 4:pos + 2 + length]))
        pos += 2 + length
        if marker == 0xDA:
            return out, data[pos:]


def _rebuild(segments, rest):
    return b'\xff\xd8' + b''.join(
        bytes([0xFF, m]) + struct.pack('>H', len(b) + 2) + b for m, b in segments) + rest


@pytest.mark.parametrize('how', ['component_ids', 'adobe_transform_0'])
def test_rgb_coded_files_equal_cv2(tmp_path, how):
    """A 3-component file without JFIF is RGB when its component ids are
    'R', 'G', 'B' or its Adobe marker says transform 0: no YCbCr
    conversion, and gray by libjpeg's RGB luma formula."""
    ok, buf = cv2.imencode('.jpg', _photo(np.random.default_rng(9), 37, 53), [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING['444']])
    segments, rest = _segments(buf.tobytes())
    segments = [(m, b) for m, b in segments if m != 0xE0]          # no JFIF
    if how == 'component_ids':
        ids = {1: ord('R'), 2: ord('G'), 3: ord('B')}
        fixed = []
        for m, b in segments:
            b = bytearray(b)
            if m == 0xC0:
                for i in range(3):
                    b[6 + 3 * i] = ids[b[6 + 3 * i]]
            elif m == 0xDA:
                for i in range(3):
                    b[1 + 2 * i] = ids[b[1 + 2 * i]]
            fixed.append((m, bytes(b)))
        segments = fixed
    else:
        segments.insert(0, (0xEE, b'Adobe' + bytes([0, 100, 0, 0, 0, 0, 0])))
    data = _rebuild(segments, rest)
    assert native.jpeg_header(data)['color_space'] == 'rgb'
    _assert_reads_like_cv2(_write(str(tmp_path / f'{how}.jpg'), data))


def test_reference_pixel_stages_equal_library():
    """The islow IDCT, the upsampling and the color tables in numpy, fed the
    library's own coefficients, give the library's pixels exactly."""
    rng = np.random.default_rng(5)
    for sampling in sorted(SAMPLING):
        for h, w in ((1, 1), (2, 3), (9, 17), (37, 53)):
            ok, buf = cv2.imencode('.jpg', _photo(rng, h, w), [
                cv2.IMWRITE_JPEG_QUALITY, 80,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
            data = buf.tobytes()
            head, blocks, tables = native.jpeg_coefficients(data)
            for gray in (False, True):
                np.testing.assert_array_equal(
                    reference.jpeg_pixels(head, blocks, tables, gray),
                    native.jpeg_decode(data, gray), err_msg=f'{sampling} {h}x{w}')


@pytest.mark.parametrize('subsampling', ['420', '444'])
def test_writer_files_read_identically_in_cv2_and_port(tmp_path, subsampling):
    rng = np.random.default_rng(6)
    for (h, w), quality in zip(SIZES + ((270, 481),), (50, 75, 90, 95, 100, 30, 95, 85)):
        img = _photo(rng, h, w)
        path = str(tmp_path / f'{h}x{w}.jpg')
        imageio.imwrite(path, img, quality=quality, subsampling=subsampling)
        _assert_reads_like_cv2(path)
        head = native.jpeg_header(open(path, 'rb').read())
        assert head['sampling'][0] == ((2, 2) if subsampling == '420' else (1, 1))
        # a faithful encoder, not only a readable one: its mean error is
        # within 10% (+0.5 level) of cv2's own encoder's at that quality
        ok, buf = cv2.imencode('.jpg', img, [
            cv2.IMWRITE_JPEG_QUALITY, quality,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[subsampling]])
        cv2_err = np.abs(cv2.imdecode(buf, cv2.IMREAD_COLOR).astype(int) - img).mean()
        err = np.abs(imageio.imread(path).astype(int) - img).mean()
        assert err <= 1.1 * cv2_err + 0.5, (h, w, quality, err, cv2_err)
    gray = _photo(rng, 33, 17, 1)
    imageio.imwrite(str(tmp_path / 'gray.jpg'), gray)
    _assert_reads_like_cv2(str(tmp_path / 'gray.jpg'))
    for orientation in range(1, 9):
        path = str(tmp_path / f'exif{orientation}.jpg')
        imageio.imwrite(path, _photo(rng, 24, 40), orientation=orientation,
                        subsampling=subsampling)
        _assert_reads_like_cv2(path)


def test_unsupported_jpegs_raise_naming_the_feature(tmp_path):
    rng = np.random.default_rng(7)
    img = _photo(rng, 32, 48)
    ok, buf = cv2.imencode('.jpg', img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    path = _write(str(tmp_path / 'progressive.jpg'), buf.tobytes())
    with pytest.raises(ValueError, match='progressive.jpg: progressive JPEG'):
        imageio.imread(path)
    data = bytearray(cv2.imencode('.jpg', img)[1].tobytes())
    sof = data.index(b'\xff\xc0')
    twelve = data[:sof + 4] + b'\x0c' + data[sof + 5:]          # 12-bit
    with pytest.raises(ValueError, match='12-bit JPEG'):
        imageio.imread(_write(str(tmp_path / 'twelve.jpg'), bytes(twelve)))
    cmyk = data[:sof + 9] + b'\x04' + data[sof + 10:]           # 4 components
    with pytest.raises(ValueError, match='4-component JPEG'):
        imageio.imread(_write(str(tmp_path / 'cmyk.jpg'), bytes(cmyk)))
    _write(str(tmp_path / 'image.gif'), b'GIF89a' + bytes(20))
    with pytest.raises(ValueError, match='neither a PNG nor a JPEG'):
        imageio.imread(str(tmp_path / 'image.gif'))


PORT_SOURCES = (glob.glob(osp.join(REPO, 'lednet_tpu_torch', '**', '*.py'), recursive=True)
                + glob.glob(osp.join(REPO, 'tools', 'torch_port_*.py'))
                + [osp.join(REPO, 'chip_smoke.py')])
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'lednet_tpu', 'cv2', 'PIL')


def test_port_sources_import_no_jax_cv2_or_pil():
    """No import statement anywhere in the port, its CLIs or the chip smoke,
    inside functions included, names JAX, flax, the JAX package, cv2 or
    PIL."""
    assert len(PORT_SOURCES) > 30
    bad = []
    for path in PORT_SOURCES:
        with open(path, encoding='utf-8') as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or '']
            bad += [(osp.relpath(path, REPO), n) for n in names
                    if n.split('.')[0] in FORBIDDEN]
    assert bad == []
