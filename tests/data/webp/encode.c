/* Writes the WebP fixtures whose encoder options Pillow cannot set, through
 * the libwebp that Pillow bundles:
 *
 *   encode IN.raw OUT.webp [key=value ...]
 *
 * IN.raw is a 12-byte header (width, height, channels: little-endian
 * uint32 each) and then the rows, RGB or RGBA. The keys are WebPConfig's
 * fields of the same names: quality, method, lossless, segments,
 * sns_strength, filter_strength, filter_sharpness, filter_type,
 * autofilter, partitions, alpha_compression, alpha_filtering,
 * alpha_quality, exact, use_sharp_yuv, near_lossless, preprocessing.
 *
 * tests/data/webp/make_fixtures.py builds it with gcc against the system's
 * webp/encode.h (encoder ABI 2.x, as Pillow's libwebp 1.6) and runs it.
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <webp/encode.h>

static uint32_t le32(const unsigned char* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
}

static int set_option(WebPConfig* c, const char* key, const char* value) {
  const double v = atof(value);
  if (!strcmp(key, "quality")) c->quality = (float)v;
  else if (!strcmp(key, "method")) c->method = (int)v;
  else if (!strcmp(key, "lossless")) c->lossless = (int)v;
  else if (!strcmp(key, "segments")) c->segments = (int)v;
  else if (!strcmp(key, "sns_strength")) c->sns_strength = (int)v;
  else if (!strcmp(key, "filter_strength")) c->filter_strength = (int)v;
  else if (!strcmp(key, "filter_sharpness")) c->filter_sharpness = (int)v;
  else if (!strcmp(key, "filter_type")) c->filter_type = (int)v;
  else if (!strcmp(key, "autofilter")) c->autofilter = (int)v;
  else if (!strcmp(key, "partitions")) c->partitions = (int)v;
  else if (!strcmp(key, "alpha_compression")) c->alpha_compression = (int)v;
  else if (!strcmp(key, "alpha_filtering")) c->alpha_filtering = (int)v;
  else if (!strcmp(key, "alpha_quality")) c->alpha_quality = (int)v;
  else if (!strcmp(key, "exact")) c->exact = (int)v;
  else if (!strcmp(key, "use_sharp_yuv")) c->use_sharp_yuv = (int)v;
  else if (!strcmp(key, "near_lossless")) c->near_lossless = (int)v;
  else if (!strcmp(key, "preprocessing")) c->preprocessing = (int)v;
  else return 0;
  return 1;
}

int main(int argc, char** argv) {
  if (argc < 3) {
    fprintf(stderr, "usage: encode IN.raw OUT.webp [key=value ...]\n");
    return 2;
  }
  FILE* f = fopen(argv[1], "rb");
  if (f == NULL) return 1;
  unsigned char head[12];
  if (fread(head, 1, 12, f) != 12) return 1;
  const int w = (int)le32(head), h = (int)le32(head + 4), ch = (int)le32(head + 8);
  const size_t n = (size_t)w * h * ch;
  unsigned char* pixels = malloc(n);
  if (pixels == NULL || fread(pixels, 1, n, f) != n) return 1;
  fclose(f);

  WebPConfig config;
  WebPPicture pic;
  WebPMemoryWriter writer;
  if (!WebPConfigInit(&config) || !WebPPictureInit(&pic)) return 1;
  for (int i = 3; i < argc; ++i) {
    char key[64];
    const char* eq = strchr(argv[i], '=');
    if (eq == NULL || eq - argv[i] >= (int)sizeof(key)) return 2;
    memcpy(key, argv[i], eq - argv[i]);
    key[eq - argv[i]] = '\0';
    if (!set_option(&config, key, eq + 1)) {
      fprintf(stderr, "unknown option %s\n", key);
      return 2;
    }
  }
  if (!WebPValidateConfig(&config)) {
    fprintf(stderr, "invalid configuration\n");
    return 1;
  }
  pic.use_argb = 1;
  pic.width = w;
  pic.height = h;
  if (!(ch == 4 ? WebPPictureImportRGBA(&pic, pixels, w * 4)
                : WebPPictureImportRGB(&pic, pixels, w * 3))) return 1;
  WebPMemoryWriterInit(&writer);
  pic.writer = WebPMemoryWrite;
  pic.custom_ptr = &writer;
  if (!WebPEncode(&config, &pic)) {
    fprintf(stderr, "encoding failed: %d\n", pic.error_code);
    return 1;
  }
  f = fopen(argv[2], "wb");
  if (f == NULL || fwrite(writer.mem, 1, writer.size, f) != writer.size) return 1;
  fclose(f);
  WebPMemoryWriterClear(&writer);
  WebPPictureFree(&pic);
  free(pixels);
  return 0;
}
