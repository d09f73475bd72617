/* Writes the JPEG fixtures that PIL cannot write, through libjpeg(-turbo 3):
 *
 *   transcode arith IN OUT [prog] [restart N] [dac]
 *       IN's coefficients, arithmetic-coded (SOF9; SOF10 with ``prog``, by
 *       jpeg_simple_progression's scans), with a restart every N MCUs, and
 *       with ``dac`` conditioning other than the defaults (DC L=1 U=3 on
 *       table 0, L=0 U=2 on table 1; AC Kx=2 and 9).
 *   transcode script IN OUT NAME
 *       IN's coefficients, progressive Huffman (SOF2) by the scan script
 *       NAME: ``ac_unrefined`` (Y's AC 1-9 stop at Al 1) or ``dc_al1`` (the
 *       DC stops at Al 1, Y's AC 6-63 and Cr's AC are never sent).
 *   transcode lossless IN.pnm OUT PSV PT [420] [restart N]
 *       IN (P5 gray or P6 RGB) as lossless (SOF3) with predictor PSV and
 *       point transform PT; colour as RGB (libjpeg's lossless default for
 *       RGB input: an Adobe marker with transform 0), or as YCbCr at 4:2:0
 *       with ``420``.
 *
 * tests/data/jpeg/make_fixtures.py builds it against the libjpeg that PIL
 * bundles (the prototypes below are libjpeg-turbo 3's, which older headers
 * lack) and runs it.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

void jpeg_enable_lossless(j_compress_ptr cinfo, int predictor_selection_value,
                          int point_transform);

static void fail(const char *msg) {
  fprintf(stderr, "transcode: %s\n", msg);
  exit(2);
}

static void set_script(j_compress_ptr c, const char *name) {
  static jpeg_scan_info scans[8];
  int n = 0;
#define SCAN(ncomp, c0, c1, c2, ss, se, ah, al)                                  \
  do {                                                                          \
    scans[n].comps_in_scan = ncomp;                                             \
    scans[n].component_index[0] = c0;                                           \
    scans[n].component_index[1] = c1;                                           \
    scans[n].component_index[2] = c2;                                           \
    scans[n].Ss = ss; scans[n].Se = se; scans[n].Ah = ah; scans[n].Al = al;     \
    ++n;                                                                        \
  } while (0)
  if (c->num_components != 3) fail("scripts are for 3 components");
  if (strcmp(name, "ac_unrefined") == 0) {
    SCAN(3, 0, 1, 2, 0, 0, 0, 0);
    SCAN(1, 0, 0, 0, 1, 9, 0, 1);
    SCAN(1, 0, 0, 0, 10, 63, 0, 0);
    SCAN(1, 1, 0, 0, 1, 63, 0, 0);
    SCAN(1, 2, 0, 0, 1, 63, 0, 0);
  } else if (strcmp(name, "dc_al1") == 0) {
    SCAN(3, 0, 1, 2, 0, 0, 0, 1);
    SCAN(1, 0, 0, 0, 1, 5, 0, 0);
    SCAN(1, 1, 0, 0, 1, 63, 0, 0);
  } else {
    fail("unknown scan script");
  }
  c->scan_info = scans;
  c->num_scans = n;
}

static void transcode(int argc, char **argv) {
  struct jpeg_decompress_struct d;
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr je, jc;
  FILE *in = fopen(argv[2], "rb"), *out = fopen(argv[3], "wb");
  if (!in || !out) fail("cannot open the files");
  d.err = jpeg_std_error(&je);
  jpeg_create_decompress(&d);
  jpeg_stdio_src(&d, in);
  jpeg_read_header(&d, TRUE);
  jvirt_barray_ptr *coefs = jpeg_read_coefficients(&d);
  c.err = jpeg_std_error(&jc);
  jpeg_create_compress(&c);
  jpeg_stdio_dest(&c, out);
  jpeg_copy_critical_parameters(&d, &c);
  if (strcmp(argv[1], "arith") == 0) {
    c.arith_code = TRUE;
    for (int i = 4; i < argc; ++i) {
      if (strcmp(argv[i], "prog") == 0) {
        jpeg_simple_progression(&c);
      } else if (strcmp(argv[i], "restart") == 0 && i + 1 < argc) {
        c.restart_interval = (unsigned)atoi(argv[++i]);
      } else if (strcmp(argv[i], "dac") == 0) {
        c.arith_dc_L[0] = 1; c.arith_dc_U[0] = 3;
        c.arith_dc_L[1] = 0; c.arith_dc_U[1] = 2;
        c.arith_ac_K[0] = 2; c.arith_ac_K[1] = 9;
      } else {
        fail("unknown option");
      }
    }
  } else {
    if (argc < 5) fail("script needs a name");
    set_script(&c, argv[4]);
  }
  jpeg_write_coefficients(&c, coefs);
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  jpeg_finish_decompress(&d);
  jpeg_destroy_decompress(&d);
  fclose(in);
  fclose(out);
}

static void lossless(int argc, char **argv) {
  FILE *in = fopen(argv[2], "rb"), *out = fopen(argv[3], "wb");
  if (!in || !out || argc < 6) fail("lossless IN.pnm OUT PSV PT [420] [restart N]");
  char magic[3] = {0};
  int w, h, maxval;
  if (fscanf(in, "%2s %d %d %d", magic, &w, &h, &maxval) != 4 || maxval != 255)
    fail("not an 8-bit PNM file");
  fgetc(in);
  const int nc = strcmp(magic, "P6") == 0 ? 3 : 1;
  unsigned char *pix = malloc((size_t)w * h * nc);
  if (fread(pix, 1, (size_t)w * h * nc, in) != (size_t)w * h * nc) fail("short PNM file");
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr jc;
  c.err = jpeg_std_error(&jc);
  jpeg_create_compress(&c);
  jpeg_stdio_dest(&c, out);
  c.image_width = w;
  c.image_height = h;
  c.input_components = nc;
  c.in_color_space = nc == 3 ? JCS_RGB : JCS_GRAYSCALE;
  jpeg_set_defaults(&c);
  for (int i = 6; i < argc; ++i) {
    if (strcmp(argv[i], "420") == 0) {
      jpeg_set_colorspace(&c, JCS_YCbCr);
      c.comp_info[0].h_samp_factor = c.comp_info[0].v_samp_factor = 2;
    } else if (strcmp(argv[i], "restart") == 0 && i + 1 < argc) {
      c.restart_interval = (unsigned)atoi(argv[++i]);
    } else {
      fail("unknown option");
    }
  }
  jpeg_enable_lossless(&c, atoi(argv[4]), atoi(argv[5]));
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = pix + (size_t)c.next_scanline * w * nc;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  free(pix);
  fclose(in);
  fclose(out);
}

int main(int argc, char **argv) {
  if (argc < 4) fail("transcode arith|script|lossless IN OUT ...");
  if (strcmp(argv[1], "lossless") == 0) lossless(argc, argv);
  else transcode(argc, argv);
  return 0;
}
