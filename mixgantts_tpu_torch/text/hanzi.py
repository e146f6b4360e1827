"""Hanzi -> TONE3 pinyin conversion for raw Chinese text input, a copy of
`mixgantts_tpu/text/hanzi.py`.

The reference converts hanzi with pypinyin at synthesis time
(`synthesize.py:70-103`: ``pinyin(text, style=Style.TONE3, strict=False,
neutral_tone_with_five=True)``).  pypinyin is not a dependency, so we ship
a compact curated table of the most common simplified characters mapped to
their most frequent Mandarin reading, plus a longest-match-first phrase
override list for high-frequency polyphones (pypinyin's own behavior:
dictionary tone per phrase, NO tone sandhi, neutral tone written as 5).

Coverage is the common-usage core (~2k characters, >99% of everyday text);
unknown characters pass through unchanged and downstream lexicon lookup
maps them to "sp" exactly as the reference does for any non-lexicon token.

Every emitted syllable is validated against the 4,120-entry pinyin lexicon
in tests (`tests/test_frontend.py`).
"""

import re

# one line per TONE3 syllable: "syllable chars...".  A polyphone may appear
# under several syllables; the FIRST occurrence in file order is its
# standalone default (tests pin the high-frequency defaults), the rest are
# reachable through _PHRASES context overrides.
_TABLE = """
a1 阿啊吖
ai1 哀埃挨唉哎
ai2 癌皑
ai3 矮蔼
ai4 爱艾碍隘暧
an1 安氨鞍庵谙
an3 俺
an4 岸按案暗黯
ang1 肮
ang2 昂
ao1 凹
ao2 熬翱遨嗷
ao3 袄
ao4 傲奥澳懊
ba1 八巴叭疤芭捌笆
ba2 拔跋
ba3 把靶
ba4 爸罢霸坝
ba5 吧
bai2 白
bai3 百柏摆佰
bai4 败拜
ban1 班般搬斑颁扳
ban3 板版
ban4 办半伴扮拌瓣绊
bang1 帮邦
bang3 绑榜膀
bang4 棒磅傍镑谤
bao1 包胞剥褒苞
bao2 雹薄
bao3 宝饱保堡
bao4 报抱暴爆豹鲍
bei1 杯悲卑碑背
bei3 北
bei4 贝备倍被辈惫狈焙
bei5 呗
ben1 奔
ben3 本
ben4 笨
beng1 崩绷
beng4 蹦迸
bi1 逼
bi2 鼻
bi3 比彼笔鄙
bi4 币必毕闭毙避壁臂碧弊蔽庇弼璧
bian1 边编鞭蝙
bian3 扁贬
bian4 变便遍辨辩辫汴
biao1 标彪膘
biao3 表
bie1 憋
bie2 别
bie3 瘪
bin1 宾滨缤彬
bing1 冰兵
bing3 丙柄饼秉禀
bing4 并病
bo1 拨波玻菠播
bo2 伯驳泊勃脖博搏膊舶渤礴
bo3 跛簸
bo5 啵
bu3 卜补捕哺
bu4 不布步怖部埠簿
ca1 擦
cai1 猜
cai2 才材财裁
cai3 采彩睬踩
cai4 菜蔡
can1 参餐
can2 残惭蚕
can3 惨
can4 灿璨
cang1 仓苍舱沧
cang2 藏
cao1 操糙
cao2 曹槽嘈
cao3 草
ce4 册侧厕测策
ceng2 层曾
ceng4 蹭
cha1 叉插
cha2 查茶察搽
cha4 差岔诧刹衩
chai1 拆
chai2 柴豺
chan2 馋缠蝉禅潺
chan3 产铲阐
chan4 颤忏
chang1 昌猖
chang2 长肠尝常偿
chang3 厂场敞
chang4 唱畅倡
chao1 抄超钞
chao2 朝潮嘲巢
chao3 吵炒
che1 车
che3 扯
che4 彻撤澈
chen2 尘辰沉陈晨臣
chen4 衬趁
chen5 伧
cheng1 称撑
cheng2 成呈诚承城乘程惩澄橙丞
cheng3 逞
cheng4 秤
chi1 吃痴嗤
chi2 池驰迟持匙
chi3 尺齿耻侈
chi4 斥赤翅炽
chong1 充冲憧
chong2 虫崇
chong3 宠
chou1 抽
chou2 仇绸愁稠酬筹畴
chou3 丑
chou4 臭
chu1 出初
chu2 除厨锄雏橱
chu3 处储楚础
chu4 触畜矗
chuai1 揣
chuan1 川穿
chuan2 传船
chuan3 喘
chuan4 串
chuang1 疮窗
chuang2 床
chuang3 闯
chuang4 创
chui1 吹炊
chui2 垂锤捶
chun1 春
chun2 纯唇醇淳
chun3 蠢
chuo1 戳
chuo4 绰
ci2 词辞慈磁雌瓷祠
ci3 此
ci4 次刺赐伺
cong1 匆葱聪
cong2 从丛
cou4 凑
cu1 粗
cu4 促醋簇
cuan4 窜篡
cui1 催摧崔
cui4 脆翠萃粹瘁
cun1 村
cun2 存
cun3 忖
cun4 寸
cuo1 搓磋撮蹉
cuo4 挫措错
da1 搭嗒耷
da2 达答瘩
da3 打
da4 大
dai1 呆
dai4 代带贷袋待戴逮怠殆黛
dai3 歹
dan1 单担丹耽郸
dan3 胆
dan4 但旦淡蛋诞弹氮惮
dang1 当铛
dang3 挡党
dang4 荡档
dao1 刀叨
dao3 导岛倒捣蹈祷
dao4 到道盗悼稻
de2 得德
de5 的
deng1 登灯蹬
deng3 等
deng4 凳邓瞪
di1 低堤滴
di2 敌笛涤迪嘀
di3 底抵诋
di4 地弟帝递第蒂缔
dian1 颠掂
dian3 典点碘
dian4 电店垫殿淀惦奠佃甸
diao1 叼雕刁凋
diao4 吊钓调掉
die1 爹跌
die2 叠碟蝶谍迭
ding1 丁叮盯钉
ding3 顶鼎
ding4 订定锭
diu1 丢
dong1 东冬
dong3 懂董
dong4 动冻洞栋
dou1 兜都
dou3 斗抖陡蚪
dou4 豆逗痘
du1 督嘟
du2 毒独读渎犊
du3 堵赌睹
du4 杜肚度渡妒镀
duan1 端
duan3 短
duan4 段断缎锻
dui1 堆
dui4 队对兑
dun1 吨蹲墩敦
dun4 顿钝盾炖
duo1 多哆
duo2 夺踱
duo3 朵躲
duo4 惰堕舵跺剁
e1 婀
e2 额俄鹅蛾讹娥
e4 饿恶扼遏鄂愕噩腭
en1 恩
en4 摁嗯
er2 儿而
er3 尔耳饵
er4 二贰
fa1 发
fa2 乏伐罚阀筏
fa3 法
fa4 珐
fan1 帆翻番藩
fan2 凡烦繁樊矾
fan3 反返
fan4 犯饭泛范贩梵
fang1 方芳坊
fang2 防妨房肪
fang3 仿访纺
fang4 放
fei1 飞非啡菲妃
fei2 肥
fei3 匪诽斐翡
fei4 吠肺废沸费痱
fen1 分吩纷芬氛
fen2 坟焚
fen3 粉
fen4 份奋愤粪忿
feng1 丰风封疯峰锋蜂枫烽
feng2 逢缝
feng3 讽
feng4 凤奉
fo2 佛
fou3 否
fu1 夫肤孵敷
fu2 伏扶服浮符幅福辐蝠俘拂袱氟涪
fu3 抚斧府俯辅腐甫脯
fu4 父付妇负附咐赴复副傅富赋缚腹覆阜驸
ga1 嘎咖
gai1 该
gai3 改
gai4 钙盖溉概丐
gan1 干甘杆肝竿尴柑
gan3 赶敢感橄秆擀
gan4 赣
gang1 刚岗纲缸钢杠肛冈
gang3 港
gao1 高膏糕羔篙皋
gao3 搞稿镐
gao4 告诰
ge1 哥胳鸽割歌戈疙咯搁
ge2 革阁格隔葛蛤
ge3 舸
ge4 个各
gei3 给
gen1 根跟
gen4 亘
geng1 耕更庚羹
geng3 埂耿梗
geng4 更
gong1 工弓公功攻供宫恭躬龚
gong3 巩汞拱
gong4 共贡
gou1 勾沟钩篝
gou3 狗苟
gou4 构购够垢诟媾
gu1 估姑孤辜菇咕沽箍
gu3 古谷股骨鼓蛊
gu4 固故顾雇锢痼
gua1 瓜刮呱
gua3 寡剐
gua4 挂褂卦
guai1 乖
guai3 拐
guai4 怪
guan1 关观官冠棺鳏
guan3 馆管莞
guan4 贯惯灌罐盥
guang1 光胱
guang3 广
guang4 逛
gui1 归龟规硅瑰闺皈
gui3 轨鬼诡癸
gui4 柜贵桂跪刽
gun3 滚辊
gun4 棍
guo1 锅郭涡
guo2 国
guo3 果裹
guo4 过
ha1 哈
hai2 还孩
hai3 海
hai4 害骇氦亥骸
han1 酣憨鼾
han2 含寒函涵韩邯
han3 喊罕
han4 汉汗旱焊憾撼翰悍捍瀚
hang2 航杭吭
hao2 毫豪嚎壕
hao3 好
hao4 号浩耗皓昊
he1 喝呵诃
he2 禾合何河和荷核盒阂涸
he4 贺赫褐鹤壑
hei1 黑嘿
hen2 痕
hen3 很狠
hen4 恨
heng1 哼亨
heng2 恒横衡蘅
heng4 横
hong1 轰哄烘
hong2 红宏洪虹鸿弘泓
hong3 哄
hong4 讧
hou2 侯喉猴
hou3 吼
hou4 后厚候侯鲎
hu1 乎呼忽糊惚
hu2 胡湖壶葫糊蝴狐弧瑚
hu3 虎唬琥
hu4 互户护沪怙
hua1 花哗
hua2 华滑划猾哗骅
hua4 化话画桦
huai2 怀徊淮槐踝
huai4 坏
huan1 欢獾
huan2 环还桓寰
huan3 缓
huan4 换唤患幻焕涣宦
huang1 荒慌
huang2 黄皇煌蝗簧凰惶徨璜
huang3 晃谎恍
huang4 晃
hui1 灰挥辉恢徽堕隳
hui2 回茴蛔
hui3 悔毁
hui4 会汇绘惠慧贿晦讳诲卉秽烩
hun1 昏婚荤
hun2 浑魂馄
hun4 混
huo1 豁
huo2 活
huo3 火伙
huo4 或货获祸惑霍豁镬
ji1 机讥击饥圾肌鸡迹积基激唧畸箕稽缉矶羁姬
ji2 及吉级即极急疾集籍辑嫉棘汲岌笈亟
ji3 己挤几给脊戟
ji4 计记纪忌技际剂季既济继寄寂祭绩冀妓伎悸骥鲫髻蓟
jia1 加夹佳家嘉枷袈珈迦
jia2 颊荚
jia3 甲假贾钾
jia4 价驾架嫁稼
jian1 尖奸歼间肩艰兼监煎拣缄笺
jian3 拣俭茧柬捡减剪检简碱睑
jian4 见件建剑荐贱健舰渐践鉴键箭溅谏毽腱
jiang1 江姜将浆僵疆缰
jiang3 讲奖桨蒋
jiang4 匠降酱绛犟
jiao1 交郊浇娇骄胶椒焦蕉礁跤
jiao3 角狡绞饺脚搅缴矫侥皎
jiao4 叫觉校轿较教酵窖
jie1 阶皆接揭街秸
jie2 节劫杰洁结捷截竭拮诘睫
jie3 姐解
jie4 介戒届界借诫藉疥
jin1 巾斤今金津筋襟矜
jin3 仅紧谨锦瑾
jin4 尽进近晋浸禁劲烬
jing1 京经茎惊晶睛精兢鲸荆旌菁
jing3 井颈景警阱
jing4 净径竞竟敬境静镜靖
jiong1 扃
jiong3 窘炯迥
jiu1 纠究揪啾鸠
jiu3 九久酒韭玖灸
jiu4 旧救就舅臼疚咎鹫厩
ju1 居拘鞠驹据掬
ju2 局菊橘桔
ju3 举沮咀矩
ju4 巨句拒具俱剧惧据距聚锯踞遽
juan1 捐娟涓鹃
juan3 卷
juan4 倦绢眷隽
jue2 决绝觉掘诀崛爵攫倔嚼
jun1 军均君菌钧
jun4 俊峻竣骏郡
ka1 咖喀
ka3 卡
kai1 开揩
kai3 凯慨楷铠
kan1 刊堪勘
kan3 砍坎侃槛
kan4 看瞰
kang1 康慷糠
kang2 扛
kang4 抗炕亢伉
kao3 考烤拷
kao4 靠铐
ke1 科棵颗柯苛磕坷瞌蝌疴
ke2 咳壳
ke3 可渴坷
ke4 克刻客课恪嗑
ken3 肯垦恳啃
keng1 坑吭铿
kong1 空
kong3 孔恐
kong4 控
kou1 抠
kou3 口
kou4 扣寇叩蔻
ku1 哭枯窟骷
ku3 苦
ku4 库裤酷
kua1 夸
kua3 垮
kua4 挎跨胯
kuai4 快块筷会侩脍
kuan1 宽髋
kuan3 款
kuang1 筐匡哐
kuang2 狂诳
kuang4 况矿框旷眶
kui1 亏窥盔
kui2 葵魁馗夔
kui3 傀
kui4 愧溃馈篑
kun1 昆坤鲲
kun3 捆
kun4 困
kuo4 扩括阔廓
la1 拉啦垃喇
la4 辣蜡腊
lai2 来莱
lai4 赖癞籁
lan2 兰拦栏蓝篮澜阑褴斓
lan3 览懒缆揽榄
lan4 烂滥
lang1 啷
lang2 狼郎廊琅榔锒
lang3 朗
lang4 浪
lao1 捞
lao2 劳牢唠痨
lao3 老佬姥潦
lao4 涝烙酪
le4 乐勒仂
le5 了
lei1 勒
lei2 雷擂镭羸
lei3 垒蕾磊儡
lei4 泪类累肋擂
leng2 棱楞
leng3 冷
leng4 愣
li2 离梨犁黎篱狸漓璃骊鹂
li3 礼李里理鲤俚娌
li4 力历厉立丽励利例隶栗粒莉荔俐痢雳呖沥枥
lian2 连帘怜莲联廉镰涟鲢
lian3 脸敛
lian4 练炼恋链殓
liang2 良凉梁粮粱踉
lia3 俩
liang3 两
liang4 亮谅辆量晾
liao1 撩
liao2 辽疗聊僚寥寮缭燎嘹
liao3 了蓼
liao4 料撂镣廖
lie1 咧
lie3 咧
lie4 列劣烈猎裂冽趔
lin2 林临邻琳磷鳞麟霖啉
lin3 凛檩
lin4 吝赁淋
ling2 令灵玲凌铃陵零龄伶羚翎聆菱
ling3 岭领
ling4 另令
liu1 溜
liu2 刘留流榴琉硫瘤遛
liu3 柳绺
liu4 六溜
long2 龙笼聋隆胧珑窿茏
long3 拢垄陇笼
lou1 搂
lou2 楼娄喽髅
lou3 搂篓
lou4 漏陋镂
lu1 噜
lu2 卢芦炉庐颅泸鲈鸬
lu3 鲁卤掳虏橹
lu4 陆录鹿碌路赂戮麓鹭辘漉露
lv2 驴榈
lv3 吕旅铝屡缕侣偻褛履
lv4 律虑率绿氯滤
luan2 峦孪挛滦銮
luan3 卵
luan4 乱
lue4 掠略
lun1 抡
lun2 伦轮论纶沦仑囵
lun4 论
luo1 啰
luo2 罗萝逻锣箩骡螺猡
luo3 裸
luo4 洛络骆落摞珞
ma1 妈抹
ma2 麻蟆
ma3 马码蚂玛
ma4 骂
mai2 埋
mai3 买
mai4 卖迈麦脉
man2 蛮馒瞒埋鳗
man3 满
man4 慢漫曼蔓幔谩
mang2 忙芒盲茫氓
mang3 莽蟒
mao1 猫
mao2 毛矛茅锚髦牦
mao3 卯铆
mao4 冒帽貌贸茂
mei2 没眉梅煤媒玫霉莓酶镁枚
mei3 每美
mei4 妹魅昧媚寐
men1 闷
men2 门
men5 们
men4 闷焖懑
meng1 蒙
meng2 萌盟檬朦
meng3 猛蒙锰蚱懵
meng4 梦孟
mi1 眯咪
mi2 迷谜弥靡糜醚
mi3 米眯
mi4 密蜜秘觅泌幂
mian2 棉眠绵
mian3 免勉缅冕娩
mian4 面
miao1 喵
miao2 苗描瞄
miao3 秒渺藐
miao4 妙庙
mie1 咩
mie4 灭蔑篾
min2 民
min3 敏悯闽皿抿
ming2 名明鸣铭冥螟
ming4 命
miu4 谬
mo1 摸
mo2 模膜摩磨魔蘑馍摹
mo3 抹
mo4 末沫莫墨默陌寞漠蓦茉殁
mou1 哞
mou2 谋眸牟
mou3 某
mu2 模
mu3 母亩姆拇牡
mu4 木目牧墓幕慕暮募睦穆沐
na2 拿
na3 哪
na4 那纳呐娜钠捺
nai3 乃奶氖
nai4 奈耐
nan2 男南难喃楠
nan4 难
nang2 囊
nao1 孬
nao2 挠铙
nao3 恼脑
nao4 闹
ne4 讷
nei4 内
nen4 嫩
neng2 能
ni1 妮
ni2 尼泥呢倪霓
ni3 你拟旎
ni4 逆匿腻溺昵
nian1 拈蔫
nian2 年粘
nian3 捻撵碾
nian4 念廿
niang2 娘
niang4 酿
niao3 鸟袅
niao4 尿
nie1 捏
nie4 聂镊镍孽
nin2 您
ning2 宁凝拧柠狞
ning4 泞佞
niu1 妞
niu2 牛
niu3 扭纽钮
nong2 农浓脓
nong4 弄
nu2 奴驽
nu3 努弩
nu4 怒
nv3 女
nuan3 暖
nue4 虐疟
nuo2 挪
nuo4 诺懦糯
o1 噢
o2 哦
ou1 欧鸥殴讴
ou3 偶呕藕
ou4 怄
pa1 趴啪
pa2 爬扒耙
pa4 怕帕
pai1 拍
pai2 排牌徘
pai4 派湃
pan1 攀潘
pan2 盘蹒磐
pan4 判盼叛畔
pang1 乓滂
pang2 旁庞螃膀磅彷
pang4 胖
pao1 抛
pao2 刨袍咆
pao3 跑
pao4 炮泡疱
pei1 胚呸
pei2 陪培赔裴
pei4 佩配沛
pen1 喷
pen2 盆
peng1 烹抨砰怦
peng2 朋棚蓬膨彭硼篷
peng3 捧
peng4 碰
pi1 批披劈坯霹
pi2 皮疲脾啤琵枇
pi3 匹劈痞癖
pi4 辟僻屁譬
pian1 片偏篇翩
pian2 便骈
pian4 骗
piao1 飘漂缥
piao2 嫖瓢
piao3 瞟
piao4 票
pie1 撇瞥
pie3 撇
pin1 拼姘
pin2 贫频嫔颦
pin3 品
pin4 聘
ping1 乒娉
ping2 平评凭瓶萍苹屏坪枰
po1 坡泼颇泊
po2 婆鄱
po4 迫破魄粕
pou1 剖
pu1 扑铺仆噗
pu2 仆菩葡蒲璞
pu3 普谱朴圃浦
pu4 瀑曝
qi1 七妻戚期欺漆凄沏柒栖
qi2 齐其奇歧骑棋旗祈脐崎淇琪琦鳍麒
qi3 乞企启起岂绮
qi4 气弃汽泣契砌器讫迄葺
qia1 掐
qia4 恰洽
qian1 千迁牵铅谦签仟歼骞阡
qian2 前钱钳潜乾虔黔
qian3 浅遣谴
qian4 欠歉嵌纤倩
qiang1 枪腔呛羌蜣锵
qiang2 强墙蔷
qiang3 抢
qiao1 敲悄锹跷橇缲
qiao2 乔侨桥瞧翘憔樵
qiao3 巧悄
qiao4 壳俏窍峭翘撬鞘
qie1 切
qie2 茄
qie3 且
qie4 怯窃惬挈锲
qin1 亲侵钦
qin2 琴禽勤秦芹擒覃
qin3 寝
qin4 沁
qing1 青轻氢倾清蜻卿
qing2 情晴擎
qing3 顷请
qing4 庆亲磬罄
qiong2 穷琼穹
qiu1 秋丘邱蚯鳅
qiu2 求球囚酋裘
qu1 区曲驱屈趋躯蛆岖祛
qu2 渠瞿
qu3 取娶龋曲
qu4 去趣
quan1 圈
quan2 权全泉拳痊诠蜷颧
quan3 犬
quan4 劝券
que1 缺阙
que2 瘸
que4 却雀确鹊阕榷
qun1 逡
qun2 群裙
ran2 然燃髯
ran3 染冉苒
rang1 嚷
rang2 瓤
rang3 壤攘嚷
rang4 让
rao2 饶娆
rao3 扰
rao4 绕
re3 惹
re4 热
ren2 人仁壬
ren3 忍荏
ren4 认任刃妊纫韧
reng1 扔
reng2 仍
ri4 日
rong2 荣绒容溶蓉熔融茸戎嵘
rong3 冗
rou2 柔揉蹂
rou4 肉
ru2 如儒蠕茹孺
ru3 乳汝辱
ru4 入褥
ruan3 软阮
rui2 蕤
rui3 蕊
rui4 锐瑞睿
run4 闰润
ruo4 若弱偌
sa1 撒仨
sa3 洒撒
sa4 萨飒卅
sai1 塞腮鳃
sai4 赛塞
san1 三叁
san3 伞
san4 散
sang1 桑丧
sang3 嗓
sang4 丧
sao1 骚搔缫臊
sao3 扫嫂
sao4 扫臊
se4 色涩瑟塞啬
sen1 森
seng1 僧
sha1 杀沙纱刹砂莎煞鲨杉
sha2 啥
sha3 傻
sha4 厦煞霎
shai1 筛
shai4 晒
shan1 山衫珊删煽杉跚潸膻
shan3 闪陕
shan4 善扇擅膳赡缮汕讪鳝
shang1 伤商殇觞
shang3 晌赏
shang4 上尚
shang5 裳
shao1 烧稍捎梢
shao2 勺芍韶
shao3 少
shao4 少绍哨邵
she1 奢赊
she2 舌蛇折佘
she3 舍
she4 设社射涉摄赦舍麝
shei2 谁
shen1 身伸深申呻绅莘
shen2 什神
shen3 审婶沈谂
shen4 甚肾渗慎蜃
sheng1 生声升牲甥笙
sheng2 绳
sheng3 省
sheng4 胜盛圣剩乘嵊
shi1 师诗施尸失狮湿虱
shi2 十什石时识实拾蚀食
shi3 史使始驶屎矢豕
shi4 士氏示世市式事侍势视试饰室恃拭是柿逝誓释嗜弑噬仕
shou1 收
shou3 手守首
shou4 寿受兽售授瘦狩绶
shu1 书叔殊梳舒疏输蔬枢淑抒
shu2 熟赎塾秫
shu3 暑鼠属薯署蜀黍
shu4 术束述树竖恕庶墅漱戍沭数
shua1 刷
shua3 耍
shuai1 衰摔
shuai3 甩
shuai4 帅率蟀
shuan1 拴栓闩
shuan4 涮
shuang1 双霜孀
shuang3 爽
shui2 谁
shui3 水
shui4 税睡
shun3 吮
shun4 顺瞬舜
shuo1 说
shuo4 硕朔烁铄
si1 司丝私思斯撕嘶厮
si3 死
si4 四寺似饲肆嗣祀伺
song1 松嵩淞
song3 耸怂悚
song4 送宋诵颂讼
sou1 搜艘嗖馊
sou3 叟
sou4 嗽
su1 苏酥
su2 俗
su4 诉肃素速宿塑溯粟簌夙
suan1 酸
suan4 算蒜
sui1 虽
sui2 随隋绥
sui3 髓
sui4 岁碎遂穗隧祟燧
sun1 孙狲
sun3 损笋榫
suo1 缩梭唆嗦娑蓑
suo3 所索锁琐
ta1 他她它塌踏蹋
ta3 塔獭
ta4 榻拓沓
tai1 胎
tai2 台抬苔邰
tai4 太态泰汰酞钛
tan1 贪摊滩瘫坍
tan2 谈弹坛昙痰潭檀谭
tan3 坦毯忐袒
tan4 叹炭探碳
tang1 汤趟蹚
tang2 堂唐糖塘膛棠搪螳瑭
tang3 倘躺淌
tang4 烫趟
tao1 掏涛滔绦韬叨
tao2 逃桃陶淘萄
tao3 讨
tao4 套
te4 特忑
teng2 疼腾藤誊
ti1 梯踢剔
ti2 提题蹄啼缇
ti3 体
ti4 替剃涕惕屉嚏悌
tian1 天添
tian2 田甜填恬
tian3 舔忝
tiao1 挑
tiao2 条调迢笤
tiao3 挑
tiao4 跳眺粜
tie1 贴帖
tie3 铁帖
tie4 帖
ting1 听厅
ting2 停庭亭廷蜓霆
ting3 挺艇
tong1 通
tong2 同铜童桐瞳彤佟酮
tong3 统桶筒捅
tong4 痛恸
tou1 偷
tou2 头投
tou4 透
tu1 突凸秃
tu2 图徒途涂屠
tu3 土吐
tu4 兔吐
tuan1 湍
tuan2 团
tui1 推
tui3 腿
tui4 退褪蜕
tun1 吞
tun2 屯豚臀囤
tuo1 脱托拖
tuo2 驼陀驮鸵沱跎
tuo3 妥椭
tuo4 唾拓
wa1 挖蛙洼哇娃
wa3 瓦
wa4 袜
wai1 歪
wai4 外
wan1 弯湾豌蜿剜
wan2 完玩顽丸烷
wan3 晚碗挽宛婉惋皖莞绾
wan4 万腕蔓
wang1 汪
wang2 王亡
wang3 往网枉惘罔
wang4 忘望旺妄
wei1 危威微巍偎薇煨
wei2 为围违唯维惟桅帷
wei3 伟伪尾纬委萎娓猥
wei4 卫未位味畏胃谓喂慰魏蔚
wen1 温瘟
wen2 文纹闻蚊雯
wen3 稳吻紊刎
wen4 问汶
weng1 翁嗡
weng4 瓮
wo1 窝蜗涡倭
wo3 我
wo4 卧握沃幄斡
wu1 乌污呜屋巫诬钨邬
wu2 无吴梧芜蜈
wu3 五午伍武舞侮捂鹉妩
wu4 勿务物误悟雾晤恶坞戊兀骛鹜
xi1 夕西吸希析息牺悉惜晰稀溪锡熙嘻膝夕矽硒蜥栖曦熄
xi2 习席袭媳檄
xi3 洗喜徙玺铣
xi4 戏系细隙
xia1 虾瞎
xia2 侠峡狭霞暇辖遐瑕匣
xia4 下吓夏厦
xian1 仙先掀鲜纤锨
xian2 闲弦贤咸衔嫌涎娴舷
xian3 显险鲜冼跣
xian4 县现限线宪陷馅羡献腺霰
xiang1 乡相香箱厢湘镶襄骧
xiang2 详祥翔降
xiang3 享响想饷
xiang4 向项象像橡巷
xiao1 消宵销萧硝霄嚣肖逍潇箫枭哮
xiao3 小晓
xiao4 孝校笑效肖啸
xie1 些歇蝎楔
xie2 协邪胁斜携谐鞋偕挟
xie3 写
xie4 泄泻卸屑械谢懈蟹邂榭薤
xin1 心辛欣新薪芯锌馨
xin4 信衅
xing1 兴星腥猩惺
xing2 行刑形型邢
xing3 醒省擤
xing4 兴杏幸性姓悻
xiong1 凶兄匈胸汹
xiong2 雄熊
xiu1 休修羞馐
xiu3 朽宿
xiu4 秀绣锈袖嗅溴
xu1 须需虚吁嘘墟戌
xu2 徐
xu3 许诩栩
xu4 旭序叙畜绪续絮蓄婿酗恤勖
xuan1 宣喧轩萱
xuan2 玄悬旋漩璇
xuan3 选癣
xuan4 眩绚炫渲旋
xue1 削靴薛
xue2 穴学
xue3 雪
xue4 血谑
xun1 勋熏薰醺
xun2 寻巡旬询循荀洵
xun4 训讯迅逊殉驯汛徇
ya1 压呀押鸦鸭丫
ya2 牙芽崖涯蚜衙
ya3 哑雅
ya4 亚轧讶娅
yan1 烟淹咽焉嫣腌胭阉
yan2 言岩沿炎研盐蜒颜阎延严檐妍
yan3 眼演掩衍奄俨魇鼹
yan4 厌宴艳验雁焰唁砚谚堰赝餍燕
yang1 央秧殃泱鸯
yang2 羊阳杨洋扬佯疡烊
yang3 仰养氧痒
yang4 样漾恙
yao1 腰邀妖吆夭
yao2 摇遥窑谣姚尧肴瑶
yao3 咬舀杳窈
yao4 要药耀钥鹞
ye1 椰噎
ye2 爷耶揶
ye3 也冶野
ye4 业叶页夜液腋谒邺晔烨
yi1 一衣医依伊壹漪揖咿
yi2 仪宜姨移遗疑胰夷怡颐彝咦贻饴
yi3 乙已以蚁倚椅矣旖
yi4 亿义艺忆议亦异役译易疫益谊意毅翼逸溢诣邑裔轶弈奕懿薏缢肄熠
yin1 因阴音姻荫茵喑殷
yin2 吟银淫寅
yin3 引饮隐瘾尹蚓
yin4 印荫
ying1 应英婴樱鹰莺缨鹦膺
ying2 迎盈莹营蝇赢萤荧嬴滢
ying3 影颖
ying4 映硬
yo1 唷哟
yong1 拥庸佣臃雍痈
yong3 永咏泳勇涌踊俑蛹恿
yong4 用佣
you1 优忧幽悠攸
you2 由邮犹油游尤铀鱿疣
you3 友有酉莠
you4 又右幼诱佑柚釉
yu1 迂淤
yu2 于余鱼娱渔愉逾愚榆隅虞舆萸禺妤
yu3 与予宇屿羽雨语伛
yu4 玉驭芋郁育狱浴预域欲遇喻寓御裕愈誉豫尉聿钰煜
yuan1 冤鸳渊眢
yuan2 元员园原圆援缘源袁猿辕垣媛
yuan3 远
yuan4 怨院愿苑
yue1 曰约
yue4 月悦阅跃越粤钥岳玥
yun1 晕氲
yun2 云匀芸耘筠
yun3 允陨殒
yun4 孕运晕韵酝蕴愠熨
za1 匝咂
za2 杂砸咋
zai1 灾栽哉
zai3 宰崽
zai4 再在载
zan1 簪
zan2 咱
zan3 攒
zan4 暂赞錾
zang1 脏赃
zang4 葬藏臧
zao1 遭糟
zao2 凿
zao3 早枣澡蚤藻
zao4 造灶燥噪躁皂
ze2 则责泽择啧咋
ze4 仄
zei2 贼
zen3 怎
zen4 谮
zeng1 增憎
zeng4 赠甑
zha1 扎渣吒楂
zha2 闸铡札
zha3 眨
zha4 乍诈炸榨栅咤
zhai1 摘斋
zhai2 宅
zhai3 窄
zhai4 债寨砦
zhan1 占沾粘毡瞻谵
zhan3 展斩盏崭辗
zhan4 战站栈绽湛蘸颤
zhang1 张章彰璋樟
zhang3 长涨掌
zhang4 丈仗帐胀障账杖嶂瘴
zhao1 招昭着朝
zhao2 着
zhao3 找爪沼
zhao4 兆召照罩肇诏赵棹笊
zhe1 遮蜇
zhe2 折哲辙蛰辄谪磔
zhe3 者褶锗赭
zhe4 这浙蔗鹧
zhe5 着
zhen1 针侦珍真斟甄贞砧臻祯榛箴
zhen3 诊枕疹缜
zhen4 阵振镇震赈朕鸩
zheng1 争征挣睁蒸筝怔峥狰症铮
zheng3 整拯
zheng4 正证政郑症帧诤
zhi1 之支只汁芝枝知织肢脂蜘吱
zhi2 执直侄值职植殖掷踯
zhi3 止旨址纸指趾咫枳
zhi4 至志制帜质治秩致智置滞稚窒炙痔挚掷峙帙栉桎轵贽
zhong1 中忠终钟衷盅忪
zhong3 肿
zhong4 众仲种重
zhou1 舟州周洲粥啁
zhou2 轴妯
zhou3 肘帚
zhou4 咒宙昼皱骤纣胄绉
zhu1 朱株珠诸猪蛛潴
zhu2 竹逐烛筑竺舳
zhu3 主拄煮嘱瞩渚
zhu4 助住注驻柱祝著蛀铸筑贮伫箸翥
zhua1 抓
zhua3 爪
zhuai4 拽
zhuan1 专砖颛
zhuan3 转
zhuan4 传赚撰转篆
zhuang1 庄装桩妆
zhuang4 壮状撞幢
zhui1 追锥椎
zhui4 坠缀赘惴
zhun1 谆肫
zhun3 准
zhuo1 捉桌拙
zhuo2 卓灼浊酌啄着琢茁斫镯浞
zi1 资姿滋咨兹孜吱淄龇趑
zi3 子仔紫籽梓
zi4 自字恣渍眦
zong1 宗棕踪鬃
zong3 总
zong4 纵粽
zou1 邹诹
zou3 走
zou4 奏揍
zu1 租
zu2 足族卒镞
zu3 组阻祖诅俎
zuan1 钻
zuan4 攥
zui3 嘴
zui4 最罪醉
zun1 尊遵樽鳟
zun3 撙
zuo2 昨琢
zuo3 左佐撮
zuo4 作坐座做柞祚胙
"""

# high-frequency polyphone phrase overrides (longest match first), the
# pypinyin phrase-dictionary behavior for the common cases where the
# in-context reading differs from the character's default above
_PHRASES = {
    "什么": ["shen2", "me5"],
    "怎么": ["zen3", "me5"],
    "那么": ["na4", "me5"],
    "这么": ["zhe4", "me5"],
    "多么": ["duo1", "me5"],
    "么": ["me5"],
    "不得不": ["bu4", "de2", "bu4"],
    "觉得": ["jue2", "de5"],
    "记得": ["ji4", "de5"],
    "显得": ["xian3", "de5"],
    "得到": ["de2", "dao4"],
    "得出": ["de2", "chu1"],
    "得以": ["de2", "yi3"],
    "获得": ["huo4", "de2"],
    "取得": ["qu3", "de2"],
    "值得": ["zhi2", "de5"],
    "懂得": ["dong3", "de5"],
    "使得": ["shi3", "de5"],
    "不得": ["bu4", "de2"],
    "还有": ["hai2", "you3"],
    "还是": ["hai2", "shi4"],
    "还在": ["hai2", "zai4"],
    "还要": ["hai2", "yao4"],
    "还没": ["hai2", "mei2"],
    "还会": ["hai2", "hui4"],
    "还能": ["hai2", "neng2"],
    "归还": ["gui1", "huan2"],
    "还给": ["huan2", "gei3"],
    "偿还": ["chang2", "huan2"],
    "银行": ["yin2", "hang2"],
    "行长": ["hang2", "zhang3"],
    "散文": ["san3", "wen2"],
    "松散": ["song1", "san3"],
    "一切": ["yi1", "qie4"],
    "密切": ["mi4", "qie4"],
    "亲切": ["qin1", "qie4"],
    "心脏": ["xin1", "zang4"],
    "内脏": ["nei4", "zang4"],
    "肝脏": ["gan1", "zang4"],
    "率领": ["shuai4", "ling3"],
    "战斗": ["zhan4", "dou4"],
    "斗争": ["dou4", "zheng1"],
    "行业": ["hang2", "ye4"],
    "一行": ["yi1", "hang2"],
    "行列": ["hang2", "lie4"],
    "了解": ["liao3", "jie3"],
    "了不起": ["liao3", "bu4", "qi3"],
    "受不了": ["shou4", "bu4", "liao3"],
    "长大": ["zhang3", "da4"],
    "成长": ["cheng2", "zhang3"],
    "长辈": ["zhang3", "bei4"],
    "队长": ["dui4", "zhang3"],
    "校长": ["xiao4", "zhang3"],
    "市长": ["shi4", "zhang3"],
    "部长": ["bu4", "zhang3"],
    "家长": ["jia1", "zhang3"],
    "增长": ["zeng1", "zhang3"],
    "长相": ["zhang3", "xiang4"],
    "音乐": ["yin1", "yue4"],
    "乐器": ["yue4", "qi4"],
    "乐曲": ["yue4", "qu3"],
    "快乐": ["kuai4", "le4"],
    "乐趣": ["le4", "qu4"],
    "重量": ["zhong4", "liang4"],
    "重要": ["zhong4", "yao4"],
    "重视": ["zhong4", "shi4"],
    "严重": ["yan2", "zhong4"],
    "重点": ["zhong4", "dian3"],
    "尊重": ["zun1", "zhong4"],
    "重复": ["chong2", "fu4"],
    "重新": ["chong2", "xin1"],
    "地方": ["di4", "fang1"],
    "地址": ["di4", "zhi3"],
    "土地": ["tu3", "di4"],
    "大地": ["da4", "di4"],
    "慢慢地": ["man4", "man4", "de5"],
    "悄悄地": ["qiao1", "qiao1", "de5"],
    "好好地": ["hao3", "hao3", "de5"],
    "地上": ["di4", "shang4"],
    "地球": ["di4", "qiu2"],
    "着急": ["zhao2", "ji2"],
    "着火": ["zhao2", "huo3"],
    "着手": ["zhuo2", "shou3"],
    "着重": ["zhuo2", "zhong4"],
    "睡着": ["shui4", "zhao2"],
    "为了": ["wei4", "le5"],
    "因为": ["yin1", "wei4"],
    "为什么": ["wei4", "shen2", "me5"],
    "好像": ["hao3", "xiang4"],
    "爱好": ["ai4", "hao4"],
    "好奇": ["hao4", "qi2"],
    "只有": ["zhi3", "you3"],
    "只是": ["zhi3", "shi4"],
    "只要": ["zhi3", "yao4"],
    "只能": ["zhi3", "neng2"],
    "一只": ["yi1", "zhi1"],
    "几只": ["ji3", "zhi1"],
    "发现": ["fa1", "xian4"],
    "头发": ["tou2", "fa4"],
    "理发": ["li3", "fa4"],
    "教书": ["jiao1", "shu1"],
    "教给": ["jiao1", "gei3"],
    "睡觉": ["shui4", "jiao4"],
    "午觉": ["wu3", "jiao4"],
    "都是": ["dou1", "shi4"],
    "都有": ["dou1", "you3"],
    "首都": ["shou3", "du1"],
    "都市": ["du1", "shi4"],
    "成都": ["cheng2", "du1"],
    "会计": ["kuai4", "ji4"],
    "便宜": ["pian2", "yi5"],
    "漂亮": ["piao4", "liang5"],
    "漂流": ["piao1", "liu2"],
    "漂浮": ["piao1", "fu2"],
    "调查": ["diao4", "cha2"],
    "调动": ["diao4", "dong4"],
    "空调": ["kong1", "tiao2"],
    "调整": ["tiao2", "zheng3"],
    "调节": ["tiao2", "jie2"],
    "强调": ["qiang2", "diao4"],
    "干净": ["gan1", "jing4"],
    "干燥": ["gan1", "zao4"],
    "干部": ["gan4", "bu4"],
    "干活": ["gan4", "huo2"],
    "能干": ["neng2", "gan4"],
    "背包": ["bei1", "bao1"],
    "背着": ["bei1", "zhe5"],
    "答应": ["da1", "ying5"],
    "应该": ["ying1", "gai1"],
    "应当": ["ying1", "dang1"],
    "反应": ["fan3", "ying4"],
    "适应": ["shi4", "ying4"],
    "应用": ["ying4", "yong4"],
    "当时": ["dang1", "shi2"],
    "当然": ["dang1", "ran2"],
    "适当": ["shi4", "dang4"],
    "上当": ["shang4", "dang4"],
    "当作": ["dang4", "zuo4"],
    "骨头": ["gu3", "tou5"],
    "石头": ["shi2", "tou5"],
    "木头": ["mu4", "tou5"],
    "关系": ["guan1", "xi5"],
    "系鞋带": ["ji4", "xie2", "dai4"],
    "朝鲜": ["chao2", "xian3"],
    "新鲜": ["xin1", "xian1"],
    "喜欢": ["xi3", "huan5"],
    "衣服": ["yi1", "fu5"],
    "舒服": ["shu1", "fu5"],
    "聪明": ["cong1", "ming5"],
    "明白": ["ming2", "bai5"],
    "时候": ["shi2", "hou5"],
    "朋友": ["peng2", "you5"],
    "先生": ["xian1", "sheng5"],
    "学生": ["xue2", "sheng5"],
    "休息": ["xiu1", "xi5"],
    "消息": ["xiao1", "xi5"],
    "意思": ["yi4", "si5"],
    "东西": ["dong1", "xi5"],
    "知识": ["zhi1", "shi5"],
    "认识": ["ren4", "shi5"],
    "孩子": ["hai2", "zi5"],
    "桌子": ["zhuo1", "zi5"],
    "椅子": ["yi3", "zi5"],
    "房子": ["fang2", "zi5"],
    "样子": ["yang4", "zi5"],
    "儿子": ["er2", "zi5"],
    "妻子": ["qi1", "zi5"],
    "日子": ["ri4", "zi5"],
    "句子": ["ju4", "zi5"],
    "杯子": ["bei1", "zi5"],
    "帽子": ["mao4", "zi5"],
    "鼻子": ["bi2", "zi5"],
    "筷子": ["kuai4", "zi5"],
    "饺子": ["jiao3", "zi5"],
    "包子": ["bao1", "zi5"],
    "兔子": ["tu4", "zi5"],
    "猴子": ["hou2", "zi5"],
    "狮子": ["shi1", "zi5"],
    "电子": ["dian4", "zi3"],
    "原子": ["yuan2", "zi3"],
    "分子": ["fen1", "zi3"],
    "女子": ["nv3", "zi3"],
    "男子": ["nan2", "zi3"],
    "子女": ["zi3", "nv3"],
    "种子": ["zhong3", "zi5"],
    "种植": ["zhong4", "zhi2"],
    "种地": ["zhong4", "di4"],
    "种树": ["zhong4", "shu4"],
    "耕种": ["geng1", "zhong4"],
    "行了": ["xing2", "le5"],
    "不行": ["bu4", "xing2"],
    "我们": ["wo3", "men5"],
    "你们": ["ni3", "men5"],
    "他们": ["ta1", "men5"],
    "她们": ["ta1", "men5"],
    "它们": ["ta1", "men5"],
    "人们": ["ren2", "men5"],
    "咱们": ["zan2", "men5"],
    "得很": ["de5", "hen3"],
    "跑得": ["pao3", "de5"],
    "走得": ["zou3", "de5"],
    "说得": ["shuo1", "de5"],
    "做得": ["zuo4", "de5"],
    "干吗": ["gan4", "ma2"],
    "吗": ["ma5"],
    "呢": ["ne5"],
    "吧": ["ba5"],
    "啊": ["a5"],
    "呀": ["ya5"],
    "啦": ["la5"],
    "嘛": ["ma5"],
    "了": ["le5"],
    "着": ["zhe5"],
    "的": ["de5"],
    "地": ["di4"],
    "得": ["de2"],
}

_readings = None


def _build_readings():
    table = {}
    for line in _TABLE.strip().splitlines():
        parts = line.split()
        syllable, chars = parts[0], "".join(parts[1:])
        for ch in chars:
            # first (most common reading) wins; duplicates are a table bug
            # caught by tests
            table.setdefault(ch, syllable)
    return table


def get_readings():
    global _readings
    if _readings is None:
        _readings = _build_readings()
    return _readings


_CJK_RE = re.compile(r"[㐀-䶿一-鿿豈-﫿]")


def contains_hanzi(text):
    return bool(_CJK_RE.search(text))


def hanzi_to_pinyin(text):
    """Convert a string to a list of TONE3 tokens, pypinyin-style:
    longest-match phrase overrides first, then per-character most-common
    readings; a RUN of consecutive non-hanzi characters passes through as
    ONE token (whitespace drops and terminates a run) — matching
    pypinyin's errors="default" segmentation, where an embedded Latin
    word like "iPhone" comes back as a single item and therefore a
    single "sp" downstream (the reference's `synthesize.py:70-103`),
    not one silence per character."""
    readings = get_readings()
    max_phrase = max(len(p) for p in _PHRASES)
    out = []
    run = []  # pending non-hanzi characters

    def flush_run():
        if run:
            out.append("".join(run))
            run.clear()

    i = 0
    while i < len(text):
        ch = text[i]
        if ch.isspace():
            flush_run()
            i += 1
            continue
        matched = False
        for n in range(min(max_phrase, len(text) - i), 1, -1):
            chunk = text[i:i + n]
            if chunk in _PHRASES:
                flush_run()
                out.extend(_PHRASES[chunk])
                i += n
                matched = True
                break
        if matched:
            continue
        if ch in _PHRASES:
            flush_run()
            out.extend(_PHRASES[ch])
        elif ch in readings:
            flush_run()
            out.append(readings[ch])
        else:
            run.append(ch)  # non-hanzi / unknown: accumulate the run
        i += 1
    flush_run()
    return out
