"""Colour previews of depth and confidence maps without matplotlib.

`plt.imsave(path, x, cmap=name)`'s decoded pixels, reproduced exactly for
float32 maps: `x` scaled to [0, 1] by its own minimum and maximum in
float32 (all zeros where they are equal), times 256 with 256 itself set to
255, truncated to an index into the colour map's 256-entry table (the
table in [0, 1] times 255, cast to uint8), written as an RGBA PNG with PIL
(its bytes differ from matplotlib's: another zlib level, no text chunks).
The viridis and magma tables below are those of matplotlib 3.10.8
(`(colormaps[name]._lut[:256] * 255).astype(np.uint8)`, RGBA rows, as hex).
"""

from __future__ import annotations

import numpy as np

_VIRIDIS = (
    "440154ff440255ff440357ff450558ff45065aff45085bff46095cff460b5eff460c5fff"
    "460e61ff470f62ff471163ff471265ff471466ff471567ff471669ff47186aff48196bff"
    "481a6cff481c6eff481d6fff481e70ff482071ff482172ff482273ff482374ff472575ff"
    "472676ff472777ff472878ff472a79ff472b7aff472c7bff462d7cff462f7cff46307dff"
    "46317eff45327fff45347fff453580ff453681ff443781ff443982ff433a83ff433b83ff"
    "433c84ff423d84ff423e85ff424085ff414186ff414286ff404387ff404487ff3f4587ff"
    "3f4788ff3e4888ff3e4989ff3d4a89ff3d4b89ff3d4c89ff3c4d8aff3c4e8aff3b508aff"
    "3b518aff3a528bff3a538bff39548bff39558bff38568bff38578cff37588cff37598cff"
    "365a8cff365b8cff355c8cff355d8cff345e8dff345f8dff33608dff33618dff32628dff"
    "32638dff31648dff31658dff31668dff30678dff30688dff2f698dff2f6a8dff2e6b8eff"
    "2e6c8eff2e6d8eff2d6e8eff2d6f8eff2c708eff2c718eff2c728eff2b738eff2b748eff"
    "2a758eff2a768eff2a778eff29788eff29798eff287a8eff287a8eff287b8eff277c8eff"
    "277d8eff277e8eff267f8eff26808eff26818eff25828eff25838dff24848dff24858dff"
    "24868dff23878dff23888dff23898dff22898dff228a8dff228b8dff218c8dff218d8cff"
    "218e8cff208f8cff20908cff20918cff1f928cff1f938bff1f948bff1f958bff1f968bff"
    "1e978aff1e988aff1e998aff1e998aff1e9a89ff1e9b89ff1e9c89ff1e9d88ff1e9e88ff"
    "1e9f88ff1ea087ff1fa187ff1fa286ff1fa386ff20a485ff20a585ff21a685ff21a784ff"
    "22a784ff23a883ff23a982ff24aa82ff25ab81ff26ac81ff27ad80ff28ae7fff29af7fff"
    "2ab07eff2bb17dff2cb17dff2eb27cff2fb37bff30b47aff32b57aff33b679ff35b778ff"
    "36b877ff38b976ff39b976ff3bba75ff3dbb74ff3ebc73ff40bd72ff42be71ff44be70ff"
    "45bf6fff47c06eff49c16dff4bc26cff4dc26bff4fc369ff51c468ff53c567ff55c666ff"
    "57c665ff59c764ff5bc862ff5ec961ff60c960ff62ca5fff64cb5dff67cc5cff69cc5bff"
    "6bcd59ff6dce58ff70ce56ff72cf55ff74d054ff77d052ff79d151ff7cd24fff7ed24eff"
    "81d34cff83d34bff86d449ff88d547ff8bd546ff8dd644ff90d643ff92d741ff95d73fff"
    "97d83eff9ad83cff9dd93aff9fd938ffa2da37ffa5da35ffa7db33ffaadb32ffaddc30ff"
    "afdc2effb2dd2cffb5dd2bffb7dd29ffbade27ffbdde26ffbfdf24ffc2df22ffc5df21ff"
    "c7e01fffcae01effcde01dffcfe11cffd2e11bffd4e11affd7e219ffdae218ffdce218ff"
    "dfe318ffe1e318ffe4e318ffe7e419ffe9e419ffece41affeee51bfff1e51cfff3e51eff"
    "f6e61ffff8e621fffae622fffde724ff"
)

_MAGMA = (
    "000003ff000004ff000006ff010007ff010109ff01010bff02020dff02020fff030311ff"
    "040313ff040415ff050417ff060519ff07051bff08061dff09071fff0a0722ff0b0824ff"
    "0c0926ff0d0a28ff0e0a2aff0f0b2cff100c2fff110c31ff120d33ff140d35ff150e38ff"
    "160e3aff170f3cff180f3fff1a1041ff1b1044ff1c1046ff1e1049ff1f114bff20114dff"
    "221150ff231152ff251155ff261157ff281159ff2a115cff2b115eff2d1060ff2f1062ff"
    "301065ff321067ff341068ff350f6aff370f6cff390f6eff3b0f6fff3c0f71ff3e0f72ff"
    "400f73ff420f74ff430f75ff450f76ff470f77ff481078ff4a1079ff4b1079ff4d117aff"
    "4f117bff50127bff52127cff53137cff55137dff57147dff58157eff5a157eff5b167eff"
    "5d177eff5e177fff60187fff61187fff63197fff651a80ff661a80ff681b80ff691c80ff"
    "6b1c80ff6c1d80ff6e1e81ff6f1e81ff711f81ff731f81ff742081ff762181ff772181ff"
    "792281ff7a2281ff7c2381ff7e2481ff7f2481ff812581ff822581ff842681ff852681ff"
    "872781ff892881ff8a2881ff8c2980ff8d2980ff8f2a80ff912a80ff922b80ff942b80ff"
    "952c80ff972c7fff992d7fff9a2d7fff9c2e7fff9e2e7eff9f2f7effa12f7effa3307eff"
    "a4307dffa6317dffa7317dffa9327cffab337cffac337bffae347bffb0347bffb1357aff"
    "b3357affb53679ffb63679ffb83778ffb93778ffbb3877ffbd3977ffbe3976ffc03a75ff"
    "c23a75ffc33b74ffc53c74ffc63c73ffc83d72ffca3e72ffcb3e71ffcd3f70ffce4070ff"
    "d0416fffd1426effd3426dffd4436dffd6446cffd7456bffd9466affda4769ffdc4869ff"
    "dd4968ffde4a67ffe04b66ffe14c66ffe24d65ffe44e64ffe55063ffe65162ffe75262ff"
    "e85461ffea5560ffeb5660ffec585fffed595fffee5b5effee5d5dffef5e5dfff0605dff"
    "f1615cfff2635cfff3655cfff3675bfff4685bfff56a5bfff56c5bfff66e5bfff6705bff"
    "f7715bfff7735cfff8755cfff8775cfff9795cfff97b5dfff97d5dfffa7f5efffa805eff"
    "fa825ffffb8460fffb8660fffb8861fffb8a62fffc8c63fffc8e63fffc9064fffc9265ff"
    "fc9366fffd9567fffd9768fffd9969fffd9b6afffd9d6bfffd9f6cfffda16efffda26fff"
    "fda470fffea671fffea873fffeaa74fffeac75fffeae76fffeaf78fffeb179fffeb37bff"
    "feb57cfffeb77dfffeb97ffffebb80fffebc82fffebe83fffec085fffec286fffec488ff"
    "fec689fffec78bfffec98dfffecb8efffdcd90fffdcf92fffdd193fffdd295fffdd497ff"
    "fdd698fffdd89afffdda9cfffddc9dfffddd9ffffddfa1fffde1a3fffce3a5fffce5a6ff"
    "fce6a8fffce8aafffceaacfffcecaefffceeb0fffcf0b1fffcf1b3fffcf3b5fffcf5b7ff"
    "fbf7b9fffbf9bbfffbfabdfffbfcbfff"
)

_TABLES = {"viridis": _VIRIDIS, "magma": _MAGMA}


def lookup_table(name: str) -> np.ndarray:
    """The colour map's 256 RGBA rows, uint8 [256, 4]."""
    return np.frombuffer(bytes.fromhex("".join(_TABLES[name])),
                         np.uint8).reshape(256, 4)


def colorize(x: np.ndarray, name: str) -> np.ndarray:
    """uint8 RGBA [H, W, 4] of a finite map, as plt.imsave colours it."""
    x = np.asarray(x, np.float32)
    lo, hi = x.min(), x.max()
    n = np.zeros_like(x) if hi == lo else (x - lo) / (hi - lo)
    i = n * np.float32(256)
    i[i == 256] = 255
    return lookup_table(name)[i.astype(np.int64)]


def save_png(path, x: np.ndarray, name: str) -> None:
    """The colourised map as an RGBA PNG at zlib level 1: the same pixels
    as matplotlib's file (level 6), written in a fraction of its time."""
    from PIL import Image

    Image.fromarray(colorize(x, name), "RGBA").save(path, compress_level=1)
